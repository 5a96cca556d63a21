"""Plain tensor ops of the port (rays, encoding, sampling, compositing);
the hand-written kernels live under ``ops/kernels``."""
