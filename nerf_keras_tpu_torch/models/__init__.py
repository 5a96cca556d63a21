"""The NeRF MLP (``nn.Module``) of the port."""
