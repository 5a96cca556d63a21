"""Drive the PyTorch port on one NVIDIA card and check it end to end.

    python chip_smoke.py

Phases (each prints one line; a failed phase raises and the script exits
nonzero — nothing falls back to the CPU or to a plain path):

1. the card, its power limit, torch/CUDA versions and the TF32 flags;
2. build the CUDA kernels from ``nerf_keras_tpu_torch/csrc`` with nvcc
   (one compiler per source, started together); report ptxas's registers,
   spills and any wgmma serialization warning;
3. K1 against its plain PyTorch version at full width (8x256, B=4096,
   S=64 and S=192), with errors and CUDA-event times; the products'
   library yardstick (one bf16 ``torch.matmul`` per padded layer at
   M = B*S, never called by the port);
4. K1 in training mode and K2 against their plain versions at the bench
   step's shapes (8x256, B=4096, S=160, random biases): per-leaf gradient
   errors against autograd of the plain K1, within a gate that a dropped
   weights cotangent misses by 10x or more; CUDA-event times;
   4b. K2 over chunks of whole rays (its workspace holds one chunk): the
   default 640 MiB budget and two smaller ones (>= 3 chunks, a ragged last
   one) within K2's gate of one chunk holding the whole batch; two runs
   bit-identical; K3 equal to K2 bit for bit at the smallest budget; time
   and per-kernel device ms at each budget; the dW product's library
   yardstick (``torch.matmul`` of each layer's A^T D, never called by the
   port);
5. K5 (the MLP over encodings) forward and backward against their plain
   versions at the parity step's shapes (8x256, N = 786,432 fine, 262,144
   coarse, and a ragged N): raw predictions, per-leaf gradients, the
   encodings' gradients, within gates that a K5 dropping the skip part of
   dx_enc, or fed a wrong layer-0 pack, misses by 10x or more;
   CUDA-event times at both passes' N;
   5b. K5's backward over chunks of samples (its workspace holds one
   chunk) at N = 786,432 with input gradients: the default 640 MiB budget
   and a smaller one (>= 3 chunks, a ragged last one) within K5's gate of
   one chunk holding the whole batch; two runs bit-identical; time and the
   device ms of the rows kernel and the dW product at each budget; the dW
   product's library yardstick;
6. serve: write a random-weight checkpoint for
   ``config/lego_batch_h256_tpu.json``, start the port's HTTP server on
   127.0.0.1, issue /healthz, three 200x200 /render and /stats, decode
   the PNGs, and check from the launch counter that K1 rendered them;
7. proposal train: the bench recipe's proposal trainer (batch 4096, 64 +
   96 samples) takes 10 steps on one fixed batch: one K1 and one K2
   launch per step by the counters, a falling loss, one step's gradients
   on the kernel path against the plain path with the same draws, the
   median step time, the step's peak memory (<= 1,536 MiB); then
   ``evaluate`` and a 200x200 frame;
8. parity train, STOP_PDF_GRADIENT=true (the default recipe at
   ``lego_batch_h256_tpu`` widths: batch 4096, 64 + 128 samples): 20
   steps, two K1 and two K2 launches per step and no K5, a falling loss,
   one step's gradients kernel path vs plain path, median step time and
   peak memory (<= 1,536 MiB); then
   ``evaluate`` and a 200x200 frame;
9. parity train, STOP_PDF_GRADIENT=false: 5 steps, two K5 forward and two
   K5 backward launches per step and no K1/K2, finite losses, one step's
   gradients kernel path vs plain path (the coarse leaves, whose gradient
   runs through sample_pdf, reported on their own), the median step time
   and peak memory (<= 1,536 MiB);
10. full render: a 200x200 frame with ``full=True`` from the phase-8
    state (two K5 launches per chunk), all eight maps checked against the
    port's CPU path on the same checkpoint (a strided subset of rays);
11. K4 (the int8 ray megakernel) against its plain version at full width
    (random weights and biases, int8 tables calibrated on orbit rays):
    B=4096 with S=64, 160 and 192, a ragged B, and the server's chunk
    (B=16384, S=64 and 192), within gates that two broken packs (the skip
    layer's x_enc rows zeroed, the fs head's sigma column dropped) miss by
    10x or more; CUDA-event times; the products' library yardstick (one
    ``torch._int_mm`` per padded int8 layer at M = B*S, never called by
    the port) at B=4096 and 16384, S=192;
12. int8 serving: the phase-6 checkpoint behind ``RenderService(quant=
    True)`` over HTTP: the PSNR gate must pass, three 200x200 /render
    with two K4 launches per chunk and no K1 launch, /stats says int8, and
    one frame is held against the port's CPU int8 path on the same tables;
13. the proposal-trained int8 render: phase 7's trainer calibrates int8
    tables and renders a 200x200 frame, one K4 launch per chunk, no K1,
    at least 30 dB of its float frame;
14. K3 (the recompute backward) against K2 on the same K1 predictions at
    B=4096 with S=64, 160 and 192 and a ragged B, with and without the
    weights cotangent: dW/db bit-equal; at S=160 against autograd of the
    plain K1 within K2's gate, which a K3 whose encode stops an octave
    short misses by 10x; the memory a recompute forward holds for its
    backward (bounded by B (20 S + 40) bytes + 1 MB) beside the residual
    forward's; CUDA-event times;
15. K6 (the MLP and compositing over per-sample encodings) forward and
    backward against their plain versions at B=4096, S=64 and 192 and a
    ragged B, within K1's and K2's gates, which a K6 reading the
    direction encodings per ray misses by 10x; a loss on its weights adds
    exactly nothing to the gradients; K6 against K1 on the same rays;
16. K7 (inverse-CDF draw fused with the sorted union) against the
    ``sample_pdf`` + ``sorted_union`` chain at its three main shapes (the
    render chunk B=16384, S=64, NF=128 on the eval grid; B=4096, S=64 with
    sorted uniforms at NF=128 and 96), with all-zero, single-spike,
    front-loaded and repeated-coarse-value rows: the coarse t-values
    bit-exact in every row, every row ascending, the same bits on a second
    run, max |diff| <= 1e-3 (and the count above 1e-5), against the chain
    in float64 no further (max, count above 1e-5) than the float32 chain,
    a K7 without the 1e-5 weight floor missing by 10x; the call time and
    the device time (``torch.profiler``) of K7 and of the chain, the
    ``torch.sort`` and ``torch.searchsorted`` yardsticks, the byte bound;
17. the parity step's three training paths
    (``nerf_keras_tpu_torch.exp_train_paths``): one step's gradients of
    the recompute path (K1 + K3) and of the encodings-in path (K6)
    against the default path (K1 + K2), then 5 steps of each with their
    launch counts (two K1 + two K3 and no K2; two K6 forward + two K6
    backward and no K1) and the memory each forward holds;
18. a 200x200 frame from the phase-8 checkpoint rendered with K7 in place
    of the chain (one K7 launch per chunk), against the engine's render;
19. ``train_cli``: the training CLI in-process (``run_training(...,
    argv=[...])`` in a temp dir, the native batcher required):
    (a) ``cli.train_synthetic --config config/lego_batch_h256_tpu.json
    --epochs 3 --eval-every 1``: every batch from the native batcher;
    exactly 2 K1 training-mode and 2 K2 launches per step, 2 K1 launches
    per eval batch and per panel render chunk, nothing else; the train
    loss and the val PSNR better at epoch 3 than at 1; the checkpoint,
    ``best.*``, the history JSON (``History.load``) and the first panel;
    per-epoch step ms and Krays/s; (b) ``--resume`` to 4 epochs: "at step
    63", 4 epochs of history, Adam's count at 84, the same launches per
    step, and a ``--profile`` window over 10 steps whose Chrome trace gives
    the device's idle share; (c) the entry point's default config
    (``lego_batch_debug.json``, BatchNorm, 25x25) for 2 epochs: no kernel
    launch, a finite falling loss, running statistics off their init; (d)
    a tiny RGBA Blender scene this script writes (6 train and 2 val frames
    of 40x40) through ``cli.train_blender`` for 1 epoch at full width,
    batch 1024; (e) ``RenderService`` on (a)'s run dir serves a 100x100
    val view from ``best.*`` (2 K1 launches), held to the ground truth;
    19b. ``visualization``: ``python -m nerf_keras_tpu_torch.visualization``
    in-process on (a)'s panels: its GIF (no mp4 encoder on the card's
    machine) read back through ``utils/gif.read_gif``, a frame per
    distinct panel at the panels' size, no kernel launch;
20. ``infer_cli``: the evaluation and inference CLIs and the server
    in-process on (19a)'s run dir: (a) ``cli.evaluate --split val``, exactly
    2 K1 launches per view (3 views of 100x100, one chunk each), a report
    that beats a random-weight checkpoint's by 1 dB, view 0 against the
    CPU path on every 40th ray (rgb 5e-3), ms per view; (b) ``--quant
    int8``: 2 K4 per view, view 0 >= 30 dB of (a)'s; (c) ``--sampler
    proposal --infer-cache``: the default distillation (1,500 x 16,384,
    wall time, final loss below the first), 1 K1 per view, the cache saved,
    and a second call that loads it and reports the same bits; the
    distillation's device time against its wall time over 100 steps; (d)
    ``--sampler proposal --quant int8``: 1 K4 per view; (e) ``cli.infer
    --frames 8 --quant int8 --sampler proposal --depth-video`` on the cache
    (the net loaded, the tables calibrated and saved): both gates, the
    launches they imply, the frame ms, and one frame's ms on each of
    float/int8 x coarse/proposal; ``e.gif`` and ``e_depth.gif`` read back
    through ``read_gif`` as 8 frames of 30 ms, looping, the depth frames
    bit for bit those handed to ``write_video`` and the rgb frames the
    writer's own palette mapping of them (their PSNR printed); the
    ``video`` line: 30 orbit frames at 800x800 on the same path, the GIF's
    encode and decode Mpx/s on the host, bytes a frame and the file's
    sha256, the frames read back gated bit for bit on the writer's own
    palette mapping and at 35 dB or more of the frames rendered, and the
    share of (e)'s wall time that ``write_video`` took; (f) the server with
    ``sampler='proposal'`` on the cache (no distillation, /stats reports
    the sampler), then on a cache of the random weights (the stale notice,
    the file overwritten);
21. ``fern_cli``: the forward-facing path at ``fern_batch_h256_tpu.json``'s
    widths (378x504, batch 4096, 64 + 128 samples, 8x256) on a synthetic
    LLFF capture this script writes (20 views of the multi-sphere scene in
    ``images_8/`` and ``poses_bounds.npy``): (a) ``cli.train_fern`` for one
    epoch (883 steps) in world space: the native batcher, exactly 2 K1
    training-mode and 2 K2 launches per step and 2 K1 per eval batch and
    panel chunk, the train loss read every 100 steps finite and falling,
    the checkpoint, step ms and Krays/s; (b) the same with ``NDC`` and a
    1,300-step frequency anneal, still open when the checkpoint is
    written: the printed bounds [0, 1], ``SCENE.ndc``, the same launches,
    and one step's gradients through ``make_grad_fn`` on the kernel path
    (the window folded into the weights in place) against the plain path
    that folds the window by autograd, with the same draws (phase 8's
    gate), the masked octaves' columns of ``trunk[0]`` exactly 0 on the
    card (so finite); (c)
    ``cli.evaluate --data llff`` on (b): 2 K1 launches per chunk, a report
    1 dB above a random-weight checkpoint's, the val view against the CPU
    path on every 40th ray, ms per view; (d) ``cli.infer --path spiral
    --frames 5``, float (K1 only) and ``--quant int8`` (the gate passes, 2
    K4 per chunk and no K1 after the gate's float frame), s per frame, each
    video read back as the port's GIF; (e) the orbit at ``--phi 0`` on (b) refused with the forward-facing
    ``ValueError`` before any launch;
22. ``dp``: data parallelism over rays (``nerf_keras_tpu_torch/parallel``)
    at the parity step's widths (8x256, 64 + 128, bf16, global batch 4096,
    random weights with nonzero biases): (a) a world of 1 on NCCL in a
    child process (``Trainer(mesh=make_mesh())``), 3 steps with exactly 2
    K1 training-mode and 2 K2 launches each, one gradient all-reduce a step
    by the collective counter and by ``torch.profiler`` over 3 more steps
    (one ``nccl:all_reduce`` host call a step; NCCL's device kernels are
    reported: over one rank it launches none), the first step's gradients
    equal, bit for bit, to one process without a mesh on the same batch
    and draws, and the step ms with and without the mesh in that process
    (CUDA events, median of 10 warm steps); (b) two ranks on gloo, both
    on ``cuda:0`` (NCCL refuses two ranks on one device; gloo is asked for
    explicitly), 2,048 rays each: exact K1/K2 launches, identical
    parameter digests after 3 steps, the reduced gradients of step 1
    against the one process on the 4,096 rays within K2's relative-L2
    gate, while a copy whose rank 1 leaves its gradients out of the
    reduce misses it by 10x; a 4,096-ray render split over the ranks with
    no all-reduce; the step ms (two processes sharing one card: not a
    scaling figure);
    22b. ``dp_infer``: scoring, rendering and serving under a mesh at the
    same widths (random weights, the sigma bias +1): (a) a world of 1 on
    NCCL in a child process calibrates int8 tables on 4 orbit views,
    distills the proposal net (cut to 200 steps of the default 1,500),
    saves the cache from rank 0 and loads it into a new trainer, and
    renders a 200x200 frame float, int8, distilled and distilled int8:
    the tables and the net (sha256) and every map bit for bit those of
    one process without a mesh, exactly 2 K1 / 2 K4 / 1 K1 / 1 K4 a chunk,
    the collectives of each step exact (calibration one header and one
    broadcast per dtype of the tables, the distillation one header and one
    of the net, the cache load one header and one per dtype, a save none,
    a render its maps' all-gathers only); (b) the same as two gloo ranks
    sharing the card (rank 1 is given a path where no cache file is): both
    ranks' digests one process's, the maps within 1e-6 of it (the
    measured maximum printed), the same collectives; (c) the broken
    variant, each rank installing the tables it calibrates itself, rank 1
    on other rays: its rows miss the 1e-6 gate by 10x or more; (d) ``cli.evaluate --quant int8
    --sampler proposal --infer-cache`` as two gloo ranks (in process,
    ``audit.run_ranks``): rank 0's report equal to one process's, one K4
    a view on each rank, rank 1 writes nothing; (e) a server
    (``serving.main``) in each served mode, float, ``--quant int8`` and
    ``--sampler proposal``, as two gloo ranks: a ``GET /render`` at
    200x200 (and ``/reload`` for int8) and ``/stats``, then SIGTERM: the
    PNG bytes, ``/reload`` and ``/stats`` equal one process's, each
    rank's launches from the server's start equal one process's exactly,
    the gate lines equal on both ranks, rank 1 writes nothing.  The
    phase's K1 and K4 launches on every rank join the kernels line;
    22c. ``tp``: tensor parallelism, ``MESH_MODEL=2``, as a (1, 2) mesh of
    two gloo ranks sharing the card at full width (8x256, L 10/4, the
    proposal bench recipe's 64 + 96 samples, bf16), 256 rays a step:
    3 split steps (no K1/K2: every float pass is the split
    ``NeRFMLP.forward``, as the JAX package resolves ``use_pallas=False``
    under a model axis), their collectives by axis pinned by the audit
    (one data-group all-reduce; the model group's all-reduces and
    all-gathers of each pass, element for element), the first step's
    reduced gradients against one process on the card running the plain
    path from the same weights and draws within K2's relative-L2 gate
    (bf16 rounds each rank's partial cotangents, as in phase 22), while
    the broken variant (the split's backward all-reduce dropped) misses it
    by 10x or more; the replicated leaves bit-identical on both ranks; the
    step ms and peak memory (not a scaling figure); ``evaluate``; the
    checkpoint written by the split run, reloaded by a second job and by
    one process (parameters equal); a 100x100 float frame (no kernel,
    within the frame gates of one process's K1 frame) and an int8 frame
    after ``quantize_for_inference`` (K4 on both ranks, one launch a
    chunk, the tables, ``infer_digest`` and every map of one process bit
    for bit).  Its K4 launches join the kernels line;
23. ``union_free``: the union-free proposal layout (``PROP_UNION=false``,
    ``PROP_AUX_SAMPLES``, ``PROP_UNION_EVERY``): (a) K1 forward, K1 in
    training mode and K2 (with the weights cotangent) at B=4096, S=128
    (the fine pass: one ray a block) and S=32 (the aux pass) against their
    plain versions within phases 3-4's gates, and K4 at the server's
    chunk B=16384, S=128 within phase 11's; CUDA-event times, bounds and
    the library yardsticks (bf16 ``torch.matmul`` per padded layer, the dW
    product's, ``torch._int_mm``); (b) the arms of the JAX package's
    ``scripts/exp_coverage_step_ab.py`` on one fixed batch in one process
    (the union 64 + 96 recipe, ``auxfree-128+32``, ``il4-128``) and
    ``docs/TRAINING.md``'s ``nounion-128`` (``profile_train.ARMS``): one step's gradients kernel path
    vs plain path with the same draws (phase 7's gate), 10 steps with
    exactly 1 K1 training-mode and 1 K2 launch a step (the aux arm 2 and
    2), the samples a ray of each launch by step (the interleave at S=192
    on steps 0, 4, 8 and S=128 between; the aux pass at S=32), a falling
    loss, the median step ms and the peak memory (<= 1,536 MiB); (c) the
    ``nounion-128`` trainer: ``evaluate`` and a 200x200 frame (K1 only, at
    S=128), the int8 frame after ``quantize_for_inference`` (K4 only, >= 30
    dB of the float frame), its checkpoint served once over HTTP (K1
    only), ``cli.evaluate`` (1 K1 a view) and ``cli.infer --frames 3`` (1
    K1 a frame, its GIF read back); (d) ``cli.train_synthetic`` for one epoch of a config
    JSON with all three knobs (aux 32, a union step every 4th, the anneal
    horizon auto): exactly the K1/K2 launches its 21 steps (1 + 1 on union
    steps, 2 + 2 else), eval and panels imply, the horizon resolved to 21.
    The kernels line adds K1, K1-train, K2 and K4 at these shapes, each
    with its launches at that S on the phase's main paths;
24. ``keras``: the reference's Keras weights, read and written by the
    port's own HDF5 code (``utils/h5.py``; this machine has no h5py):
    (a) the committed Keras 3 fixtures (``tests/fixtures/ref_tiny_{plain,
    bn}.weights.h5``) imported and run through the plain ``NeRFMLP`` in
    float32 on the card, TF32 off, BatchNorm in inference mode, within
    2e-4 of ``ref_tiny_golden.npz`` (hidden 32 has no K1 instantiation,
    so this part is plain by design); (b) seeded random coarse+fine params
    at full width exported, then ``cli.infer --reference-weights --frames
    3``: the frames equal, bit for bit, those of the same params installed
    with ``replace_params``, with exactly 2 K1 launches a frame; ``--quant
    int8``: the gate's float and int8 frames, then 2 K4 launches a frame
    where the gate keeps int8 (else 2 K1); (c) a BatchNorm file at full
    width renders one frame with no kernel launch (BatchNorm runs the
    plain MLP); (d) ``cli.export_keras`` on phase 19's run directories (no
    BatchNorm, and the BatchNorm default config), re-imported: exactly the
    trainer's eval params and running statistics.  Import, export and
    frame host ms on the card's machine.
25. ``fern_jpeg``: a user's own capture shipped as full-size JPEGs only
    (``tests/fixtures/torch_jpeg/capture``: 8 views of 504x672, PIL's
    quality 90, 4:2:0), run after ``fern_cli`` on a copy: (a) the port's
    decoder (``utils/jpeg.py``, host C++ built with g++) on every fixture
    file and ``data/llff.minify`` (Pillow's LANCZOS by 8 into
    ``images_8/*.png``) on the capture, each frame's uint8 SHA-256 equal
    to PIL's (``goldens.json``; this machine has no PIL); the decode Mpx/s
    and the minify seconds on the card's host; (b) ``cli.train_fern
    --config config/fern_batch_h256_tpu.json --epochs 1`` on it (63x84
    frames resized to 378x504, 7 train views, 325 steps): the native
    batcher, exactly 2 K1 training-mode and 2 K2 launches per step and 2 K1
    per eval batch and panel chunk, the loss read every 100 steps finite
    and falling; (c) ``cli.evaluate --data llff`` on its checkpoint, 2 K1
    launches per chunk, 1 dB above a random-weight checkpoint's report;
    (d) ``cli.infer --path spiral --frames 2``, float (K1 only) and
    ``--quant int8`` (the gate passes, then K4 only).
26. ``widths``: any hidden width up to 512 on the zero-padded packs, at
    B = 1,024, S = 64: K1 (both modes), K2, K3, K5 (with input gradients)
    and K6 at hidden 16, 96 and 192 (padded to 64, 128, 256) against their
    plain versions at the same width within the bf16 gates of phases 3-5,
    14 and 15, and at 64, 128 and 256 for the padding's cost in time; K1,
    K2 and K5 with input gradients at (L_XYZ, L_DIR) = (4, 2) and (16, 6)
    (64/32 and 128/64 gradient columns) at hidden 96 and 256; K4 at hidden
    48, 96 and 192 (padded int8 tables) within phase 11's gates; a
    checkpoint, ``infer_digest`` and a Keras export at hidden 96 hold the
    same bytes in every array before and after the padded packs are built;
    and above 256 on the hidden-512 kernels (the 64-row tile whose two
    warpgroups split each layer's columns): every kernel of the suite
    (K5's backward without input gradients, which raise above 256) at
    hidden 320 (padded to 512) and 512, within the same gates, each also
    run on a forward pack whose second warpgroup's trunk columns are zero,
    which must miss its gate by 10x; K4 at 320 and 512, and its tables
    with the skip rows zeroed missing by 10x; the same at hidden 1024 (the
    split tile in column passes of 512: every kernel of the suite and K4);
26b. ``wide``: the 8x512 main path (``config/lego_batch_h256_tpu.json``
    with HIDDEN_DIM 512: 8 layers, skip 4, L 10/4, 64 + 128 samples, batch
    4096, bf16, random biases): one step's gradients kernel path vs plain
    path (same draws), 10 parity steps through K1 + K2 (two K1
    training-mode and two K2 launches a step, the loss lower after the
    last than after the first, peak memory <= 1,536 MiB);
    a 200x200 float frame (two K1 a chunk), int8 tables calibrated on it and
    its int8 frame through K4 alone (two a chunk) at >= 30 dB of the float
    frame; the checkpoint served once over HTTP (two K1 a chunk); then K1,
    K1 in training mode and K2 at B = 4096, S = 192 and K4 at B = 16384, S
    = 192 against their plain versions, with CUDA-event times, bounds and
    library yardsticks, for the kernels line's 8x512 entries (their
    launches are this phase's main path's); K2's dW product (the split
    tile's windows, ``csrc/nerf_dw.cuh``: ``mlp_dw_window_kernel``) by its
    device ms in all and a chunk's launch beside its bound (the workspace
    read once, or its products) and one ``torch.matmul`` of A^T D a layer,
    with a plan missing layer 0's tiles that must miss K2's gate by 10x;
    K1, K2 and K5 on one ray of 64 samples of the phase's trained model;
    K4 on
    tables with the skip layer's x_enc rows zeroed must miss its gates by
    10x;
26c. ``wide1024``: the same main path at HIDDEN_DIM 1024 (mip-NeRF 360's
    8x1024 MLP) on the hidden-1024 kernels (column passes of 512): the
    gradient check on the batch's first 1,024 rays (the plain path's
    autograd over 4,096 x 192 samples would not fit the card), 10 parity
    steps at batch 4096 whose loss falls, peak <= 1,280 MiB a step, and 2
    more through the recompute path (K1 + K3); the float and int8 200x200
    frames; then K1, K1-train, K2 and K3 (K2's bits)
    at B = 4096, S = 192 and K4 at B = 16384, S = 192 against their plain
    versions (the plain K2 and K4 over chunks of rays), with the broken dW
    plan and K4 tables, times, bounds and yardsticks, for the kernels
    line's 8x1024 entries; the one-tile suite at 1024;
27. ``f32``: COMPUTE_DTYPE=float32 at ``lego_batch_h256_tpu``'s widths:
    (a) each f32 kernel (``csrc/fused_render_f32.cu``: K1 both modes, K2,
    K3, K5 forward and backward with input gradients, K6 forward and
    backward) against its plain version (f32 products, TF32 off) with the
    parameter gradients' sums over the batch and the compositing in
    float64, at B = 4,096, S = 192, within 1e-5 relative L2 on every
    output and gradient (the plain f32 version beside it: its own f32 sums
    and compositing VJP err by ~1e-5 on the sigma head), while the bf16 kernels on a bf16 copy of the same weights and
    inputs miss it by 10x or more; CUDA-event times, the bound at the card's f32 FFMA peak
    (SMs x 128 x 2 x the maximum SM clock) and the f32 ``torch.matmul``
    yardsticks (the forward's products, the dW product, the whole
    backward's products); the backward alone in all four modes (K3 and K6
    without their forwards, those times kept as ``ms_with_forward``), its
    device ms by kernel (compositing VJP, ``f32_rows_kernel``,
    ``f32_dw_kernel``, reduce), two launches of K2 and of K5 bit for bit,
    and the f32 source's ``-Xptxas -v`` lines; (b) one parity step's
    gradients kernel path vs plain path
    (same draws, 1e-3), 3 steps each through K1+K2, K1+K3, K6 and K5
    (``STOP_PDF_GRADIENT=false``) and 3 proposal-recipe steps, each with
    exact f32 launches and no bf16 launch; (c) ``evaluate`` and a 200x200
    frame from ``Trainer.render_image`` (f32 K1 only); (d) one ``GET
    /render`` from the server on the f32 checkpoint (2 f32 K1 a chunk);
    (e) the verify recipe's tiny f32 config through ``cli.train_synthetic``
    (f32 K1/K2 only, the loss falling over 3 epochs).  The kernels line
    adds the eight f32 kernels with their launches on (b)-(e).
28. ``captures``: a user's own capture in the PNG and JPEG layouts PIL
    reads, run last on copies of the committed fixtures: (a) the port's
    PNG decoder (``utils/png.py`` with the host C++ unfilter
    ``utils/native/png.cc``, built with g++) on the Blender scene of
    ``tests/fixtures/torch_png`` (16-bit RGBA, Adam7, palette + ``tRNS``
    at 8 and 4 bits, 16-bit gray+alpha) and the progressive JPEG decoder on
    every ``prog_*`` case and the progressive capture, each frame's uint8
    SHA-256 equal to PIL's (``goldens.json``; this machine has no PIL); an
    800x800 RGBA frame whose every row is Paeth, at 8 and 16 bits, decoded
    exactly; decode Mpx/s of those two and of a progressive 504x672 view
    on the card's host; (b) ``cli.train_blender`` on the scene at full
    width (40x40, batch 1024, white background, 5 epochs of 9 steps, the
    native batcher, exactly 2 K1 training-mode and 2 K2 launches a step and
    2 K1 per eval batch and panel chunk, a falling loss), then
    ``cli.evaluate --data blender`` (2 K1 launches, 1 dB above a
    random-weight checkpoint's report); (c) the progressive capture
    (``tests/fixtures/torch_jpeg/capture_progressive``, 8 views):
    ``data/llff.minify`` against PIL's digests, ``cli.train_fern --config
    config/fern_batch_h256_tpu.json --epochs 1`` (as 25 (b)), then
    ``cli.infer --path spiral --frames 1`` (K1 only, 2 a chunk), its GIF
    read back.

The videos are the port's GIFs (``utils/gif.py``; the card's machine has
no mp4 encoder): each ``cli.infer`` run's file reads back as the frames
handed to ``write_video``, in the writer's own palette mapping, bit for
bit.

Each main path runs with the launch counters set to 0 just before it and
read just after.  The line before the last is the kernel report
``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {"platform": "gpu", ...}}``.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import hashlib
import io
import json
import math
import os
import re
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import zlib

import numpy as np
import torch
from torch.nn.utils import parametrize

from nerf_keras_tpu_torch import exp_train_paths, exp_wide_numerics, load_config, runtime
from nerf_keras_tpu_torch.engine.step import (
    aux_samples,
    draw_t_vals,
    make_grad_fn,
    make_loss_fn,
    make_render_fn,
    make_train_step,
    params_of,
    union_step,
)
from nerf_keras_tpu_torch.engine.trainer import Trainer
from nerf_keras_tpu_torch.models.mlp import (
    NeRFMLP,
    is_skip,
    random_params,
    randomize_biases_,
)
from nerf_keras_tpu_torch.ops.encoding import encode_position
from nerf_keras_tpu_torch.ops.proposal import distill_proposal
from nerf_keras_tpu_torch.ops.kernels import _build, fused_f32
from nerf_keras_tpu_torch.ops.kernels import fused_mlp as k5
from nerf_keras_tpu_torch.ops import quant
from nerf_keras_tpu_torch.ops.kernels import fused_render as k1
from nerf_keras_tpu_torch.ops.kernels import pdf_union as k7
from nerf_keras_tpu_torch.ops.kernels import quant_render as k4
from nerf_keras_tpu_torch.ops.rays import get_rays, pose_spherical, sample_rays
from nerf_keras_tpu_torch.ops.sampling import generate_t_vals
from nerf_keras_tpu_torch.exp_train_paths import counts
from nerf_keras_tpu_torch.profile_train import (
    ARMS,
    UNION_ARM,
    arm_config,
    bench_batch,
    bench_config,
    parity_config,
)
from nerf_keras_tpu_torch.runtime import cuda_ms, device_ms_by_kernel
from nerf_keras_tpu_torch.serving import RenderService, serve
from nerf_keras_tpu_torch.cli import evaluate as eval_cli
from nerf_keras_tpu_torch.cli import export_keras as export_cli
from nerf_keras_tpu_torch.cli import infer as infer_cli
from nerf_keras_tpu_torch.cli import train as train_cli
from nerf_keras_tpu_torch.cli import train_blender, train_fern, train_synthetic
from nerf_keras_tpu_torch.data import llff
from nerf_keras_tpu_torch.data import native as native_batcher
from nerf_keras_tpu_torch.data.pipeline import dataset_to_ndc
from nerf_keras_tpu_torch.data.synthetic import write_forward_facing_capture
from nerf_keras_tpu_torch.ops.freq_anneal import anneal_alpha, freq_window
from nerf_keras_tpu_torch.parallel.audit import (
    artifact_digests,
    free_port,
    run_ranks,
    run_two_process_smoke,
    tree_rel_l2,
)
from nerf_keras_tpu_torch.profile_render import union_us
from nerf_keras_tpu_torch.config import NeRFConfig
from nerf_keras_tpu_torch.utils.checkpoint import (
    _flatten,
    checkpoint_name,
    models_to_jax,
    resolve_checkpoint,
    resolve_infer_config,
    save_params_npz,
)
from nerf_keras_tpu_torch.utils import jpeg as jpeg_codec
from nerf_keras_tpu_torch.utils import png as png_codec
from nerf_keras_tpu_torch.utils.image import to_uint8
from nerf_keras_tpu_torch.utils.keras_export import export_reference_weights
from nerf_keras_tpu_torch.utils.keras_import import import_reference_weights
from nerf_keras_tpu_torch.utils.image_metrics import frame_psnr
from nerf_keras_tpu_torch.utils.metrics import History
from nerf_keras_tpu_torch.utils.png import decode_png, encode_png, png_transparency, to_rgba
from nerf_keras_tpu_torch.utils.gif import decode_gif, encode_gif, read_gif, shown_frames
from nerf_keras_tpu_torch import visualization

# K1 vs plain at full width.  Both take bf16-rounded operands and
# accumulate in f32; they differ in summation order, which can flip the
# bf16 rounding of a hidden activation, and in the order of the
# transmittance product.  On an H100 with these weights (random biases)
# that is max |diff| 1.7e-4 and mean 2.7e-6 for rgb/weights, in [0, 1];
# the gates sit ~30x above.  A pack with zeroed or shifted biases errs by
# 0.57+ (max) and 0.019+ (mean).
TOL_MAX = 5e-3
TOL_MEAN = 1e-4
# A frame rendered on the card against the plain path on the CPU: the fine
# samples follow the coarse weights, so a small weight difference moves
# them a little (on an H100, 24x24: rgb 1.5e-4, depth 1.6e-3).
FRAME_TOL_RGB = 5e-3
FRAME_TOL_DEPTH = 2e-2
# The full render's weights (in [0, 1]) and raw predictions against the
# CPU path: on an H100 (1,000 rays of a 200x200 frame) weights 7.7e-5,
# raw predictions 2.6e-3 (coarse) and 6.2e-3 (fine, whose samples follow
# the coarse weights); the raw predictions take K5's own gate.
FRAME_TOL_WEIGHTS = 5e-3

# K2 against autograd of the plain K1, per parameter leaf: relative L2
# error (||kernel - plain|| / ||plain||).  Both take bf16 operands with f32
# accumulation but round the cotangents at other places and sum in
# another order, so the error grows down the trunk: on an H100 at B=4096,
# S=160 (random biases) 8.8e-3 at trunk.0.weight, 3.3e-3 at trunk.7,
# < 2.2e-3 in the heads.  A kernel that drops the weights cotangent reads
# 21.6 against this gate (checked every run: it must miss by 10x).
K2_TOL_REL = 2e-2
# K1's raw-prediction residual against the plain MLP on its encodings
# (rgb logits and sigma, unbounded): 5.0e-3 max |diff| on an H100.
PREDS_TOL = 5e-2
# One train step's gradients, kernel path against plain path on the card
# with the same draws (per leaf, relative L2): 7.8e-3 on an H100.
STEP_TOL_REL = 2e-2
# K5's raw predictions against the plain MLP on the same bf16 encodings:
# the products are K1's, so K1's residual gate (PREDS_TOL) holds for the
# max, and the mean is held 50x tighter.
K5_PREDS_MAX = PREDS_TOL
K5_PREDS_MEAN = 1e-3
# K5's gradients against autograd of the plain MLP, per leaf and for
# dx_enc/dd_enc: relative L2.  The same bf16 operands, cotangents rounded
# at other places (as K2): K2's gate.
K5_TOL_REL = K2_TOL_REL
# STOP_PDF_GRADIENT=false: the coarse leaves' gradient runs through
# sample_pdf's 1/denominator (floored at 1e-5), which amplifies the fine
# pass's bf16 rounding differences (K5's dx_enc against the plain one) by
# up to 1e5 on a few rays.  On an H100 at batch 4096: 0.16 in the coarse
# sigma head, 0.009-0.02 in the other coarse leaves, against 3.5e-3 in the
# fine leaves; the coarse gate sits 3x above.
PDF_COARSE_TOL_REL = 0.5

# K4 against its plain version on the same int8 tables: the integer
# pipeline is the same, so what is left is the compositing's order (and an
# encoding that a sin/cos ulp could carry across an int8 boundary).  On an
# H100 at B=4096, S=64/192: max |diff| 3.6e-7, mean 6.3e-8 (rgb); the gates
# sit ~3000x and ~150x above, and broken packs must miss them by 10x.
K4_TOL_MAX = 1e-3
K4_TOL_MEAN = 1e-5
# The int8 PSNR gate against the float render (the server's default).
QUANT_GATE_DB = 30.0

# Peak device memory over a train step (max_memory_allocated over what was
# allocated before it): the backward's workspace (K2's, K5's) holds one
# chunk (ops/kernels/fused_render.py: DW_CHUNK_BYTES), so the step stays
# below this at batch 4096 whatever the samples per ray (on an H100: 942
# MiB proposal, 831 MiB parity; 7.6-7.9 GB before the chunks, 8,039 MiB
# for STOP_PDF_GRADIENT=false while K5 held the whole batch's workspace).
STEP_PEAK_MIB = 1536

PEAK_BF16 = 989e12  # H100 SXM dense bf16 tensor-core FLOP/s (data sheet)
PEAK_INT8 = 1979e12  # H100 SXM dense int8 tensor-core OP/s (data sheet)
HBM_BYTES_S = 3.35e12  # H100 SXM device memory bytes/s (data sheet)

CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "config", "lego_batch_h256_tpu.json")
SOURCES = {
    "K1": ("nerf_keras_tpu_torch/csrc/fused_render_fwd.cu",
           "nerf_keras_tpu/ops/pallas/fused_render.py:709"),
    "K2": ("nerf_keras_tpu_torch/csrc/fused_render_bwd.cu",
           "nerf_keras_tpu/ops/pallas/fused_render.py:453"),
    "K5f": ("nerf_keras_tpu_torch/csrc/fused_mlp_fwd.cu",
            "nerf_keras_tpu/ops/pallas/fused_mlp.py:148"),
    "K5b": ("nerf_keras_tpu_torch/csrc/fused_render_bwd.cu",
            "nerf_keras_tpu/ops/pallas/fused_mlp.py:260"),
    "K4": ("nerf_keras_tpu_torch/csrc/quant_render_fwd.cu",
           "nerf_keras_tpu/ops/pallas/quant_render.py:66"),
    "K3": ("nerf_keras_tpu_torch/csrc/fused_render_bwd.cu",
           "nerf_keras_tpu/ops/pallas/fused_render.py:425"),
    "K6f": ("nerf_keras_tpu_torch/csrc/fused_render_fwd.cu",
            "nerf_keras_tpu/ops/pallas/fused_render.py:336"),
    "K6b": ("nerf_keras_tpu_torch/csrc/fused_render_bwd.cu",
            "nerf_keras_tpu/ops/pallas/fused_render.py:350"),
    "K7": ("nerf_keras_tpu_torch/csrc/pdf_union.cu", "experimental/pdf_union.py:54"),
}
# The float32 kernels (one source), by the JAX kernel each replaces in its
# float32 instantiation.
F32_SOURCE = "nerf_keras_tpu_torch/csrc/fused_render_f32.cu"
SOURCES.update({f"{k}-f32": (F32_SOURCE, SOURCES[k][1])
                for k in ("K1", "K2", "K3", "K5f", "K5b", "K6f", "K6b")})
# K2 at 8x512 and 8x1024, and K3 at 8x1024: the rows kernel's libraries of
# those widths.
SOURCES.update({f"K2-{w}": (f"nerf_keras_tpu_torch/csrc/fused_render_bwd_{w}.cu",
                            SOURCES["K2"][1]) for w in (512, 1024)})
SOURCES["K3-1024"] = (SOURCES["K2-1024"][0], SOURCES["K3"][1])


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + json.dumps(fields), flush=True)


def full_mlp(dev: torch.device, seed: int) -> NeRFMLP:
    gen = torch.Generator().manual_seed(seed)
    return randomize_biases_(
        NeRFMLP(num_layers=8, hidden_dim=256, skip_layer=4, l_xyz=10, l_dir=4,
                compute_dtype=torch.bfloat16, generator=gen, device=dev),
        gen,
    )


# ---------------------------------------------------------------------------
# The least time the card could take for a kernel's work: the larger of its
# products at the bf16 tensor-core peak and its bytes (each input read once,
# each output written once) at the memory rate.

def mlp_macs(mlp: NeRFMLP) -> int:
    """Multiply-adds of one forward of the MLP per sample (every weight once)."""
    return sum(layer.weight.numel() for layer in (*mlp.trunk, *mlp.heads().values()))


def mlp_dx_macs(mlp: NeRFMLP, input_grads: bool) -> int:
    """Multiply-adds of the backward's dX products per sample: every weight
    with input gradients; without, less layer 0, the skip columns and the
    branch's direction columns (whose gradients nothing reads)."""
    total = mlp_macs(mlp)
    if input_grads:
        return total
    hid = mlp.hidden_dim
    skip = sum(mlp.xyz_dim * hid for i in range(mlp.num_layers) if is_skip(i, mlp.skip_layer))
    return total - mlp.trunk[0].weight.numel() - skip - mlp.dir_dim * mlp.branch.weight.shape[0]


def param_bytes(mlp: NeRFMLP) -> int:
    return sum(p.numel() for p in mlp.parameters()) * 4


def bound(flops: float, nbytes: float, peak: float = PEAK_BF16) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def k1_bound(mlp, b, s, train):
    n = b * s
    nbytes = b * (24 + 12) + n * (4 + 4) + param_bytes(mlp) // 2
    if train:
        nbytes += n * (mlp.xyz_dim * 2 + 16)
    return bound(2.0 * mlp_macs(mlp) * n, nbytes)


def k2_bound(mlp, b, s):
    n = b * s
    flops = 2.0 * (mlp_macs(mlp) + mlp_dx_macs(mlp, False)) * n
    nbytes = n * (mlp.xyz_dim * 2 + 16 + 4 + 4) + b * (12 + 12) + 3 * param_bytes(mlp)
    return bound(flops, nbytes)


def dw_bound(mlp, dev, n):
    """The dW product of a backward over ``n`` samples (csrc/nerf_dw.cuh):
    A^T D of every layer at its padded widths, at the
    bf16 peak; or its bytes: the workspace (each sample's bf16 A and D)
    read once and the f32 dW written once."""
    fwd, bwd = k1.kernel_pack(mlp, dev), k1.kernel_pack_bwd(mlp, dev)
    layout = k1.workspace_layout(fwd, bwd)
    out = int((layout[:, 1] * layout[:, 3]).sum())
    return bound(2.0 * out * n, n * k1.DwBuffers.bytes_per_sample(fwd, bwd) + 4 * out)


def _broken_dw_allocate(orig):
    """``DwBuffers.allocate`` whose split-tile dW plan lacks layer 0's
    tiles (its weight gradient left at zero): a dW product that misses a
    tile must miss K2's gate by 10x."""
    def allocate(*args, **kw):
        ws = orig(*args, **kw)
        ws.dw_part.zero_()
        return ws._replace(tiles=np.ascontiguousarray(ws.tiles[ws.tiles[:, 0] != 0]))
    return allocate


def k4_bound(mlp, b, s):
    """int8 products at the int8 peak; rays and t in, rgb and weights out,
    the int8 pack and its f32 scale/bias/requant rows read once."""
    n = b * s
    outs = sum(layer.weight.shape[0] for layer in (*mlp.trunk, *mlp.heads().values()))
    nbytes = b * (24 + 12) + n * (4 + 4) + mlp_macs(mlp) + outs * 12
    return bound(2.0 * mlp_macs(mlp) * n, nbytes, PEAK_INT8)


def k5_bounds(mlp, n, input_grads):
    enc = (mlp.xyz_dim + mlp.dir_dim) * 2
    fwd = bound(2.0 * mlp_macs(mlp) * n, n * (enc + 16) + param_bytes(mlp) // 2)
    flops = 2.0 * (mlp_macs(mlp) + mlp_dx_macs(mlp, input_grads)) * n
    nbytes = n * (enc + 16 + (enc if input_grads else 0)) + 3 * param_bytes(mlp)
    return fwd, bound(flops, nbytes)


def k3_bound(mlp, b, s):
    """K2's products; it reads the rays instead of the x_enc residual."""
    n = b * s
    flops = 2.0 * (mlp_macs(mlp) + mlp_dx_macs(mlp, False)) * n
    nbytes = n * (16 + 4 + 4) + b * (12 + 12 + 12) + 3 * param_bytes(mlp)
    return bound(flops, nbytes)


def k6_bounds(mlp, b, s):
    """K6's forward (encodings, t in; rgb, weights out) and its backward
    (encodings, predictions, t, the rgb cotangent in; dW/db out)."""
    n = b * s
    enc = (mlp.xyz_dim + mlp.dir_dim) * 2
    fwd = bound(2.0 * mlp_macs(mlp) * n, n * (enc + 4 + 4) + b * 12 + param_bytes(mlp) // 2)
    flops = 2.0 * (mlp_macs(mlp) + mlp_dx_macs(mlp, False)) * n
    bwd = bound(flops, n * (enc + 16 + 4) + b * 12 + 3 * param_bytes(mlp))
    return fwd, bwd


def k7_bound(b, s, nf, u_given):
    """Bytes: t and w in, (u in), the union out; a few hundred f32
    operations per ray, far below."""
    return bound(0.0, b * (s * 8 + (s + nf) * 4 + (nf * 4 if u_given else 0)))


def kernel_entry(name, key, launches, max_abs_err, ms, plain_ms, bnd,
                 library_ms=None) -> dict:
    source, replaces = SOURCES[key]
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": max_abs_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
            "library_ms": library_ms}


def reset_counts() -> None:
    k1.launches = k1.train_launches = k1.bwd_launches = k1.recompute_launches = 0
    k1.enc_launches = k1.enc_bwd_launches = 0
    k5.launches = k5.bwd_launches = 0
    k4.launches = k7.launches = 0
    fused_f32.launches = fused_f32.train_launches = fused_f32.bwd_launches = 0
    fused_f32.recompute_launches = fused_f32.enc_launches = fused_f32.enc_bwd_launches = 0
    fused_f32.mlp_launches = fused_f32.mlp_bwd_launches = 0




# ---------------------------------------------------------------------------

def phase_card() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: no card")
    runtime.configure_numerics()
    card = runtime.card_string()
    print(card, flush=True)
    say("card", card=card, torch=torch.__version__, cuda=torch.version.cuda,
        device=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(),
        matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
        cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
    return card


def phase_build() -> None:
    seconds = _build.build()
    ptxas = [line.strip() for line in _build.build_log.splitlines()
             if line.startswith("==") or "registers" in line or "spill" in line
             or "serialized" in line]
    # The kernels that spill, by name (ptxas reports a function's spills
    # after the line that names it).
    spills, name = [], None
    for line in _build.build_log.splitlines():
        found = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
        if found:
            name = found.group(1)
        elif re.search(r"[1-9]\d* bytes spill stores", line) and name not in spills:
            spills.append(name)
    for src in _build._sources():
        _build.load(src.stem)  # loads the library, declares argtypes
    say("build", seconds=seconds,
        libraries=[_build.library_path(s).name for s in _build._sources()],
        ptxas=ptxas, spills=spills)


def library_products_ms(desc: np.ndarray, m: int, dtype: torch.dtype, dev) -> float:
    """The products alone as one PyTorch call per layer at M = ``m`` rows,
    on the padded (k_pad, n_pad) shapes of a pack's descriptors:
    ``torch._int_mm`` (s32 out) for int8, ``torch.matmul`` for bf16.  A
    yardstick timed here and used nowhere in the port."""
    gen = torch.Generator(device=dev).manual_seed(0)
    if dtype == torch.int8:
        def rand(*shape):
            return torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8, device=dev)
        mm = torch._int_mm
    else:
        def rand(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(dtype)
        mm = torch.matmul
    acts = {k: rand(m, k) for k in sorted({int(k) for k in desc[:, 0]})}
    # B column-major, cuBLAS's native layout for int8.
    mats = [(acts[int(k)], rand(int(n), int(k)).t()) for k, _, n, _, _ in desc]

    def products():  # each output dropped before the next (8x512's would take 61 GB)
        for a, w in mats:
            mm(a, w)

    ms = cuda_ms(products)
    del acts, mats
    torch.cuda.empty_cache()
    return ms


def phase_kernel(card: str) -> dict:
    """K1 vs render_rays_reference at the main path's shapes."""
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    mlp = full_mlp(dev, 0)
    origins, dirs = get_rays(64, 64, 1.2 * 64, pose_spherical(30.0, -30.0, 4.0),
                             device=dev)
    origins = origins.reshape(-1, 3).contiguous()
    dirs = dirs.reshape(-1, 3).contiguous()
    b = origins.shape[0]
    report = {"max_abs_err": 0.0}
    with torch.inference_mode():
        for s in (64, 192):
            t = generate_t_vals(2.0, 6.0, (b,), s, "stratified",
                                generator=gen).to(dev).contiguous()
            args = (mlp, origins, dirs, t)
            rgb_k, w_k = k1.render_rays_fused(*args)
            torch.cuda.synchronize()
            rgb_p, w_p = k1.render_rays_reference(*args)
            torch.cuda.synchronize()
            d_rgb = (rgb_k - rgb_p).abs()
            d_w = (w_k - w_p).abs()
            errs = {
                "rgb_max": d_rgb.max().item(), "rgb_mean": d_rgb.mean().item(),
                "w_max": d_w.max().item(), "w_mean": d_w.mean().item(),
            }
            finite = bool(torch.isfinite(rgb_k).all() and torch.isfinite(w_k).all())
            ms = cuda_ms(lambda: k1.render_rays_fused(*args))
            plain_ms = cuda_ms(lambda: k1.render_rays_reference(*args))
            bnd = k1_bound(mlp, b, s, train=False)
            say("k1", B=b, S=s, **errs, tol_max=TOL_MAX, tol_mean=TOL_MEAN,
                finite=finite, ms=ms, plain_ms=plain_ms, bound_ms=bnd[0],
                bound_by=bnd[1], card=card)
            if not finite:
                raise RuntimeError(f"K1 produced non-finite values at S={s}")
            if (errs["rgb_max"] > TOL_MAX or errs["w_max"] > TOL_MAX
                    or errs["rgb_mean"] > TOL_MEAN or errs["w_mean"] > TOL_MEAN):
                raise RuntimeError(f"K1 disagrees with the plain version at S={s}: {errs}")
            report["max_abs_err"] = max(report["max_abs_err"],
                                        errs["rgb_max"], errs["w_max"])
            report[f"ms_s{s}"] = ms
            report[f"plain_ms_s{s}"] = plain_ms
            report[f"bound_s{s}"] = bnd
    report["library_ms_s192"] = library_products_ms(k1.kernel_pack(mlp, dev).desc, b * 192,
                                                    torch.bfloat16, dev)
    say("k1_library", B=b, S=192, library_ms=report["library_ms_s192"], card=card)
    return report


def _rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(got.float() - want.float())
                 / torch.linalg.vector_norm(want.float()).clamp_min(1e-30))


def _leaf_errors(got: list, want: list) -> tuple[float, float]:
    """(max |diff| over all leaves, max per-leaf relative L2 error)."""
    max_abs = max(float((g - w).abs().max()) for g, w in zip(got, want))
    return max_abs, max(_rel_l2(g, w) for g, w in zip(got, want))


def _k2_inputs(dev):
    """The bench step's shapes (B=4096 rays, S=160 = 64 + 96): the MLP,
    rays, t-values and cotangents of comparable size for rgb and weights,
    so that either one dropped moves the gradients far beyond the gate."""
    gen = torch.Generator().manual_seed(1)
    mlp = full_mlp(dev, 1)
    _, origins, dirs = (torch.as_tensor(x, device=dev) for x in bench_batch(4096))
    b, s = origins.shape[0], 160
    t = generate_t_vals(2.0, 6.0, (b,), s, "stratified", generator=gen).to(dev).contiguous()
    g_rgb = (torch.randn((b, 3), generator=gen) * 1e-3).to(dev)
    g_w = (torch.randn((b, s), generator=gen) * 1e-3).to(dev)
    return mlp, origins, dirs, t, g_rgb, g_w


def phase_k2(card: str) -> dict:
    """K1 in training mode and K2 against their plain versions at the
    bench step's shapes (B=4096 rays, S=160 = 64 + 96)."""
    dev = torch.device("cuda")
    mlp, origins, dirs, t, g_rgb, g_w = _k2_inputs(dev)
    b, s = t.shape
    params = list(mlp.parameters())
    with torch.no_grad():
        rgb_t, w_t, x_enc, preds = k1.launch_k1(mlp, origins, dirs, t, 10, 4, train=True)
        rgb_f, w_f, _, _ = k1.launch_k1(mlp, origins, dirs, t, 10, 4, train=False)
        got = k1.launch_k2(mlp, x_enc, dirs, t, preds, g_rgb, g_w, 10, 4)
        torch.cuda.synchronize()
    if not (torch.equal(rgb_t, rgb_f) and torch.equal(w_t, w_f)):
        raise RuntimeError("K1 in training mode changed its rgb/weights")
    with torch.enable_grad():
        rgb_p, w_p = k1.render_rays_reference(mlp, origins, dirs, t)
    with torch.no_grad():
        pts = origins[:, None, :] + dirs[:, None, :] * t[..., None]
        x_plain = encode_position(pts, 10).reshape(b * s, -1).to(torch.bfloat16)
        enc_err = float((x_enc.float() - x_plain.float()).abs().max())
        d_enc = encode_position(dirs, 4)[:, None, :].expand(b, s, -1).reshape(b * s, -1)
        preds_err = float((preds - mlp(x_enc.float(), d_enc)).abs().max())
        del x_plain, d_enc, pts
    want = list(torch.autograd.grad([rgb_p, w_p], params, [g_rgb, g_w], retain_graph=True))
    want_no_gw = list(torch.autograd.grad([rgb_p], params, [g_rgb], retain_graph=True))
    max_abs, rel = _leaf_errors(got, want)
    _, rel_dropped = _leaf_errors(got, want_no_gw)
    finite = all(bool(torch.isfinite(g).all()) for g in got) and bool(torch.isfinite(preds).all())
    with torch.no_grad():
        k1_train_ms = cuda_ms(lambda: k1.launch_k1(mlp, origins, dirs, t, 10, 4, train=True))
        k1_plain_ms = cuda_ms(lambda: k1.render_rays_reference(mlp, origins, dirs, t))
        k2_ms = cuda_ms(lambda: k1.launch_k2(mlp, x_enc, dirs, t, preds, g_rgb, g_w, 10, 4))
    plain_bwd_ms = cuda_ms(lambda: torch.autograd.grad(
        [rgb_p, w_p], params, [g_rgb, g_w], retain_graph=True))
    leaves = {name: _leaf_errors([g], [w])[1]
              for (name, _), g, w in zip(mlp.named_parameters(), got, want)}
    k1t_bnd, k2_bnd = k1_bound(mlp, b, s, train=True), k2_bound(mlp, b, s)
    say("k2", B=b, S=s, max_abs_err=max_abs, max_rel_l2=rel, tol_rel=K2_TOL_REL,
        rel_l2_vs_plain_without_gw=rel_dropped, x_enc_max_err=enc_err,
        preds_max_err=preds_err, finite=finite, k1_train_ms=k1_train_ms,
        k1_plain_fwd_ms=k1_plain_ms, k1_train_bound_ms=k1t_bnd[0], k2_ms=k2_ms,
        plain_bwd_ms=plain_bwd_ms, k2_bound_ms=k2_bnd[0], rel_l2_by_leaf=leaves, card=card)
    if not finite:
        raise RuntimeError("K1 residuals or K2 gradients are not finite")
    if enc_err > 1e-2 or preds_err > PREDS_TOL:
        raise RuntimeError(f"K1's residuals disagree with the plain encode/MLP: "
                           f"x_enc {enc_err}, preds {preds_err}")
    if rel > K2_TOL_REL:
        raise RuntimeError(f"K2 disagrees with the plain backward: rel L2 {rel}")
    if rel_dropped < 10 * K2_TOL_REL:
        raise RuntimeError(
            f"the gate cannot see a dropped weights cotangent: {rel_dropped} "
            f"< 10 x {K2_TOL_REL}")
    del rgb_p, w_p
    k1_train_library_ms = library_products_ms(k1.kernel_pack(mlp, dev).desc, b * s,
                                              torch.bfloat16, dev)
    say("k1_train_library", B=b, S=s, library_ms=k1_train_library_ms, card=card)
    return {"max_abs_err": max_abs, "ms": k2_ms, "plain_ms": plain_bwd_ms, "bound": k2_bnd,
            "k1_train_err": preds_err, "k1_train_ms": k1_train_ms,
            "k1_train_plain_ms": k1_plain_ms, "k1_train_bound": k1t_bnd,
            "k1_train_library_ms": k1_train_library_ms}


# K2's kernels, by the names the profiler reports.
K2_STAGES = {"vjp": ("composite_vjp_kernel",), "rows": ("k2_rows_kernel",),
             "dw": ("mlp_dw_kernel", "mlp_dw_window_kernel"), "reduce": ("mlp_reduce_kernel",)}
# Workspace budgets of K2's chunks (bytes): the default, and two that force
# several chunks with a ragged last one; the smallest keeps a chunk's A/D
# (~40 MB at 10,112 B per sample) inside the 50 MB L2 between the rows
# kernel and the dW product.
K2_BUDGETS = {"mid": 160 << 20, "l2": 40 << 20}


def phase_k2_chunks(card: str) -> dict:
    """K2 over chunks of whole rays at the bench step's shapes: the default
    budget and two that force several chunks with a ragged last one, each
    within K2's gate of one chunk holding the whole batch; run twice at the
    default (identical bits); K3 against K2 bit for bit at the smallest budget;
    times and the per-kernel breakdown at each budget; the dW product's
    library yardstick (``torch.matmul`` of A^T D per layer over the batch,
    never called by the port)."""
    dev = torch.device("cuda")
    mlp, origins, dirs, t, g_rgb, g_w = _k2_inputs(dev)
    b, s = t.shape
    default = k1.DW_CHUNK_BYTES
    fwd, bwd = k1.kernel_pack(mlp, dev), k1.kernel_pack_bwd(mlp, dev)
    bps = k1.DwBuffers.bytes_per_sample(fwd, bwd)
    fields = {}
    with torch.no_grad():
        _, _, x_enc, preds = k1.launch_k1(mlp, origins, dirs, t, 10, 4, train=True)
        run = lambda: k1.launch_k2(mlp, x_enc, dirs, t, preds, g_rgb, g_w, 10, 4)  # noqa: E731
        base = run()
        again = run()
        torch.cuda.synchronize()
        deterministic = all(torch.equal(x, y) for x, y in zip(base, again))
        try:
            k1.DW_CHUNK_BYTES = 1 << 40  # one chunk: the whole batch's workspace
            one = run()
            torch.cuda.synchronize()
            one_ms = cuda_ms(run)
            fields["one_chunk"] = {"ms": one_ms, "device_ms": device_ms_by_kernel(run, K2_STAGES),
                                   "rel_l2_vs_default": _leaf_errors(base, one)[1]}
            base = one
            del one
            for name, budget in {"default": default, **K2_BUDGETS}.items():
                k1.DW_CHUNK_BYTES = budget
                plan = k1.chunk_plan(b, s, bps)
                got = run()
                torch.cuda.synchronize()
                max_abs, rel = _leaf_errors(got, base)
                fields[name] = {
                    "budget_mib": budget / 2**20, "chunks": len(plan),
                    "rays_per_chunk": plan[0][1], "last_chunk_rays": plan[-1][1],
                    "max_abs_vs_one_chunk": max_abs, "rel_l2_vs_one_chunk": rel,
                    "ms": cuda_ms(run), "device_ms": device_ms_by_kernel(run, K2_STAGES)}
                if name == "l2":
                    k3 = k1.launch_k3(mlp, origins, dirs, t, preds, g_rgb, g_w, 10, 4)
                    fields["k3_bit_equal_k2_at_l2"] = all(
                        torch.equal(x, y) for x, y in zip(k3, got))
                    del k3
                del got
        finally:
            k1.DW_CHUNK_BYTES = default
        del base, again, x_enc, preds
        torch.cuda.empty_cache()
        library_ms = _dw_library_ms(mlp, dev, b * s)
        bwd_library_ms = _bf16_backward_library_ms(mlp, dev, b * s)
    say("k2_chunks", B=b, S=s, bytes_per_sample=bps, deterministic=deterministic,
        dw_library_ms=library_ms, bwd_library_ms=bwd_library_ms, tol_rel=K2_TOL_REL,
        **fields, card=card)
    if not deterministic:
        raise RuntimeError("K2 run twice gave different bits")
    if not fields["k3_bit_equal_k2_at_l2"]:
        raise RuntimeError("K3 differs from K2 at the chunked size")
    for name in K2_BUDGETS:
        f = fields[name]
        if f["chunks"] < 3 or f["last_chunk_rays"] >= f["rays_per_chunk"]:
            raise RuntimeError(f"budget {name} did not give >= 3 chunks with a ragged last one")
        if f["rel_l2_vs_one_chunk"] > K2_TOL_REL:
            raise RuntimeError(f"K2 in chunks ({name}) disagrees with one chunk: "
                               f"{f['rel_l2_vs_one_chunk']}")
    return {"library_ms": library_ms, "bwd_library_ms": bwd_library_ms, "budgets": fields}


def _k5_inputs(dev, n, seed):
    """bf16 encodings of N points along random rays between near and far,
    unit directions, and a cotangent for the raw predictions."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    o = torch.randn((n, 3), generator=gen, device=dev) * 0.3 + torch.tensor([0.0, 0.0, 4.0], device=dev)
    d = torch.randn((n, 3), generator=gen, device=dev)
    d = d / d.norm(dim=-1, keepdim=True)
    t = torch.rand((n, 1), generator=gen, device=dev) * 4.0 + 2.0
    x_enc = encode_position(o + d * t, 10).to(torch.bfloat16).contiguous()
    d_enc = encode_position(d, 4).to(torch.bfloat16).contiguous()
    g = torch.randn((n, 4), generator=gen, device=dev) * 1e-2
    return x_enc, d_enc, g


def _broken_pack(mlp: NeRFMLP, dev, what: str) -> k1.KernelPack:
    """K5's input-gradient pack (wgmma layout) with the skip rows zeroed
    (``skip``: dx_enc loses the skip part) or layer 0's rows zeroed
    (``layer0``: it loses the layer-0 product); every other product is
    unchanged."""
    mats = [m.detach().clone() for m, _ in k1._bwd_layers(mlp, input_grads=True)]
    hid = mlp.hidden_dim
    if what == "layer0":
        mats[0].zero_()
    else:
        for i in range(1, mlp.num_layers + 1):
            if is_skip(i - 1, mlp.skip_layer):
                mats[i][hid:] = 0.0
    return k1._pack_wg([(m, None) for m in mats], dev)


# K5's backward kernels, by the names the profiler reports.
K5_STAGES = {"rows": ("k5_rows_kernel",), "dw": ("mlp_dw_kernel",),
             "reduce": ("mlp_reduce_kernel",)}
# A workspace budget that splits K5's fine pass (N = 786,432) into >= 3
# chunks of samples with a ragged last one.
K5_SMALL_BUDGET = 160 << 20


def _dw_library_ms(mlp: NeRFMLP, dev, n: int) -> float:
    """The dW stage's library yardstick: one ``torch.matmul`` of A^T D per
    layer over ``n`` samples (bf16 operands of the workspace's widths),
    never called by the port."""
    layout = k1.workspace_layout(k1.kernel_pack(mlp, dev), k1.kernel_pack_bwd(mlp, dev))
    pairs = [(torch.randn((n, int(a)), device=dev, dtype=torch.bfloat16),
              torch.randn((n, int(d)), device=dev, dtype=torch.bfloat16))
             for a, d in zip(layout[:, 1], layout[:, 3])]
    ms = cuda_ms(lambda: [torch.matmul(a.t(), d) for a, d in pairs])
    del pairs
    torch.cuda.empty_cache()
    return ms


def _bf16_backward_library_ms(mlp: NeRFMLP, dev, m: int, input_grads: bool = False) -> float:
    """The whole bf16 backward's products as one ``torch.matmul`` each per
    padded layer at M = ``m`` rows, never called by the port: the
    recomputed forward A W of the layers the rows kernel recomputes (all
    but the rgb head), dX = D W^T of the layers its walk runs (layer 0's
    too with ``input_grads``) and dW = A^T D of every layer, at the packs'
    and the workspace's widths."""
    fwd = k1.kernel_pack(mlp, dev)
    bwd = k1.kernel_pack_bwd(mlp, dev, input_grads=input_grads)
    layout = k1.workspace_layout(fwd, bwd)
    gen = torch.Generator(device=dev).manual_seed(0)
    acts = {}

    def act(k):
        if k not in acts:
            acts[k] = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        return acts[k]

    def mat(k, n):
        return torch.randn((k, n), generator=gen, device=dev).to(torch.bfloat16)

    first = 0 if input_grads else 1
    products = [(act(int(k)), mat(int(k), int(n)))
                for k, _, n, _, _ in (*fwd.desc[:mlp.num_layers + 2], *bwd.desc[first:])]
    dw = [(act(int(a)), act(int(d))) for _, a, _, d, _ in layout]

    def backward():  # each output dropped before the next
        for a, w in products:
            torch.matmul(a, w)
        for a, d in dw:
            torch.matmul(a.t(), d)

    ms = cuda_ms(backward, reps=3)
    del acts, products, dw
    torch.cuda.empty_cache()
    return ms


def phase_k5_chunks(card: str) -> dict:
    """K5's backward over chunks of samples at the fine pass's N = 786,432
    with input gradients: one chunk (the whole batch's workspace), the
    default budget and one that forces >= 3 chunks with a ragged last one,
    each within K5's gate of one chunk; run twice at the default (identical
    bits); times and the device ms of the rows kernel and the dW product at
    each budget; the dW stage's library yardstick."""
    dev = torch.device("cuda")
    mlp = full_mlp(dev, 5)
    n = 4096 * 192
    x_enc, d_enc, g = _k5_inputs(dev, n, seed=n)
    default = k1.DW_CHUNK_BYTES
    bps = k1.DwBuffers.bytes_per_sample(k1.kernel_pack(mlp, dev), k1.kernel_pack_bwd(mlp, dev))
    fields = {}
    run = lambda: k5.launch_k5_bwd(mlp, x_enc, d_enc, g, True, True)  # noqa: E731
    flat = lambda r: [*r[0], r[1], r[2]]  # noqa: E731
    with torch.no_grad():
        base = flat(run())
        deterministic = all(torch.equal(a, b) for a, b in zip(base, flat(run())))
        try:
            k1.DW_CHUNK_BYTES = 1 << 40
            one = flat(run())
            torch.cuda.synchronize()
            fields["one_chunk"] = {"ms": cuda_ms(run),
                                   "device_ms": device_ms_by_kernel(run, K5_STAGES)}
            for name, budget in (("default", default), ("small", K5_SMALL_BUDGET)):
                k1.DW_CHUNK_BYTES = budget
                plan = k1.chunk_plan(n, 1, bps)
                got = flat(run())
                torch.cuda.synchronize()
                fields[name] = {
                    "budget_mib": budget / 2**20, "chunks": len(plan),
                    "samples_per_chunk": plan[0][1], "last_chunk_samples": plan[-1][1],
                    "rel_l2_vs_one_chunk": max(_rel_l2(a, b) for a, b in zip(got, one)),
                    "ms": cuda_ms(run), "device_ms": device_ms_by_kernel(run, K5_STAGES)}
                del got
        finally:
            k1.DW_CHUNK_BYTES = default
        del base, one
    del x_enc, d_enc, g
    torch.cuda.empty_cache()
    library_ms = _dw_library_ms(mlp, dev, n)
    # The whole backward's products: K5's with input gradients, and K6's
    # backward at S=192 (the same M, no input gradients).
    bwd_library_ms = {"k5": _bf16_backward_library_ms(mlp, dev, n, input_grads=True),
                      "k6": _bf16_backward_library_ms(mlp, dev, n)}
    say("k5_chunks", N=n, input_grads=True, bytes_per_sample=bps,
        deterministic=deterministic, dw_library_ms=library_ms,
        bwd_library_ms=bwd_library_ms, tol_rel=K5_TOL_REL, **fields, card=card)
    if not deterministic:
        raise RuntimeError("K5's backward run twice gave different bits")
    small = fields["small"]
    if small["chunks"] < 3 or small["last_chunk_samples"] >= small["samples_per_chunk"]:
        raise RuntimeError("K5's small budget did not give >= 3 chunks with a ragged last one")
    for name in ("default", "small"):
        if fields[name]["rel_l2_vs_one_chunk"] > K5_TOL_REL:
            raise RuntimeError(f"K5 in chunks ({name}) disagrees with one chunk: "
                               f"{fields[name]['rel_l2_vs_one_chunk']}")
    return {"library_ms": library_ms, "bwd_library_ms": bwd_library_ms, "budgets": fields}


def phase_k5(card: str) -> dict:
    """K5 vs its plain versions at the parity step's shapes: the fine pass
    (N = 4096 x 192, with input gradients, as STOP_PDF_GRADIENT=false runs
    it), the coarse pass (N = 4096 x 64, without: its encodings carry no
    gradient) and a ragged N."""
    dev = torch.device("cuda")
    mlp = full_mlp(dev, 5)
    params = list(mlp.parameters())
    report = {"fwd_max_abs_err": 0.0, "bwd_max_abs_err": 0.0}
    for n, need in ((4096 * 192, True), (4096 * 64, False), (100_003, True)):
        x_enc, d_enc, g = _k5_inputs(dev, n, seed=n)
        with torch.no_grad():
            out = k5.launch_k5_fwd(mlp, x_enc, d_enc)
            got, dx, dd = k5.launch_k5_bwd(mlp, x_enc, d_enc, g, need, need)
            torch.cuda.synchronize()
            want_out = mlp(x_enc, d_enc)
        diff = (out - want_out).abs()
        fwd = {"max": float(diff.max()), "mean": float(diff.mean())}
        del want_out, diff
        want, want_dx, want_dd = k5.apply_nerf_mlp_reference_vjp(mlp, x_enc, d_enc, g, need)
        max_abs, rel = _leaf_errors(got, want)
        leaves = {name: _rel_l2(a, b) for (name, _), a, b in zip(mlp.named_parameters(), got, want)}
        finite = bool(torch.isfinite(out).all()) and all(bool(torch.isfinite(a).all()) for a in got)
        fields = {}
        if need:
            finite = finite and bool(torch.isfinite(dx.float()).all() and torch.isfinite(dd.float()).all())
            fields["dx_rel_l2"] = _rel_l2(dx, want_dx)
            fields["dd_rel_l2"] = _rel_l2(dd, want_dd)
            orig = k1.kernel_pack_bwd
            for what in ("skip", "layer0"):
                broken = _broken_pack(mlp, dev, what)
                k1.kernel_pack_bwd = lambda m, d, input_grads=False, b=broken: b  # noqa: E731
                try:
                    _, bdx, _ = k5.launch_k5_bwd(mlp, x_enc, d_enc, g, True, True)
                finally:
                    k1.kernel_pack_bwd = orig
                fields[f"dx_rel_l2_{what}_broken"] = _rel_l2(bdx, want_dx)
        timing = {}
        if n == 4096 * 64:  # the coarse pass: times only
            with torch.no_grad():
                timing["fwd_ms"] = cuda_ms(lambda: k5.launch_k5_fwd(mlp, x_enc, d_enc))
                timing["bwd_ms"] = cuda_ms(
                    lambda: k5.launch_k5_bwd(mlp, x_enc, d_enc, g, False, False))
        if n == 4096 * 192:
            with torch.no_grad():
                timing["fwd_ms"] = cuda_ms(lambda: k5.launch_k5_fwd(mlp, x_enc, d_enc))
                timing["fwd_plain_ms"] = cuda_ms(lambda: mlp(x_enc, d_enc))
                timing["bwd_ms"] = cuda_ms(
                    lambda: k5.launch_k5_bwd(mlp, x_enc, d_enc, g, True, True))
            xl = x_enc.float().requires_grad_()
            dl = d_enc.float().requires_grad_()
            with torch.enable_grad():
                preds = mlp(xl, dl)
            timing["bwd_plain_ms"] = cuda_ms(lambda: torch.autograd.grad(
                [preds], params + [xl, dl], [g], retain_graph=True))
            del preds, xl, dl
            fwd_bnd, bwd_bnd = k5_bounds(mlp, n, input_grads=True)
            timing.update(fwd_bound_ms=fwd_bnd[0], fwd_bound_by=fwd_bnd[1],
                          bwd_bound_ms=bwd_bnd[0], bwd_bound_by=bwd_bnd[1])
            report.update(timing, fwd_bound=fwd_bnd, bwd_bound=bwd_bnd)
        say("k5", N=n, input_grads=need, preds_max=fwd["max"], preds_mean=fwd["mean"],
            tol_preds_max=K5_PREDS_MAX, tol_preds_mean=K5_PREDS_MEAN,
            grad_max_abs=max_abs, grad_max_rel_l2=rel, tol_rel=K5_TOL_REL, **fields,
            finite=finite, rel_l2_by_leaf=leaves, **timing, card=card)
        if not finite:
            raise RuntimeError(f"K5 produced non-finite values at N={n}")
        if fwd["max"] > K5_PREDS_MAX or fwd["mean"] > K5_PREDS_MEAN:
            raise RuntimeError(f"K5's forward disagrees with the plain MLP at N={n}: {fwd}")
        bad = [k for k in ("dx_rel_l2", "dd_rel_l2") if fields.get(k, 0.0) > K5_TOL_REL]
        if rel > K5_TOL_REL or bad:
            raise RuntimeError(f"K5's backward disagrees with the plain one at N={n}: "
                               f"{rel} {fields}")
        for what in ("skip", "layer0"):
            if need and fields[f"dx_rel_l2_{what}_broken"] < 10 * K5_TOL_REL:
                raise RuntimeError(f"the dx_enc gate cannot see a K5 with a broken {what} "
                                   f"pack: {fields} < 10 x {K5_TOL_REL}")
        report["fwd_max_abs_err"] = max(report["fwd_max_abs_err"], fwd["max"])
        report["bwd_max_abs_err"] = max(report["bwd_max_abs_err"], max_abs)
        del x_enc, d_enc, g, got, dx, dd, want, want_dx, want_dd, out
        torch.cuda.empty_cache()
    return report


def _orbit_rays(dev, size: int = 64) -> tuple[torch.Tensor, torch.Tensor]:
    """The rays of 8 poses around the object (theta every 45 degrees, phi
    -30, radius 4), ``size`` x ``size`` each, as the server calibrates."""
    rays = [get_rays(size, size, 1.2 * size, pose_spherical(theta, -30.0, 4.0), device=dev)
            for theta in range(0, 360, 45)]
    return (torch.cat([o.reshape(-1, 3) for o, _ in rays]),
            torch.cat([d.reshape(-1, 3) for _, d in rays]))


def _calibrated_qparams(mlp: NeRFMLP, dev) -> dict:
    """``mlp``'s int8 tables, calibrated on 2048 orbit rays at 192 centred
    samples each."""
    o, d = _orbit_rays(dev)
    idx = torch.as_tensor(np.random.default_rng(0).choice(o.shape[0], 2048, replace=False),
                          device=dev)
    o, d = o[idx], d[idx]
    t = generate_t_vals(2.0, 6.0, (o.shape[0],), 192, "center", device=dev)
    pts = o[:, None, :] + d[:, None, :] * t[..., None]
    d_enc = encode_position(d, mlp.l_dir)[:, None, :].expand(*t.shape, -1)
    tree = quant.mlp_tree(mlp)
    stats = quant.mlp_calibration_absmax(tree, encode_position(pts, mlp.l_xyz), d_enc,
                                         mlp.skip_layer)
    return quant.quantize_mlp(tree, stats, mlp.skip_layer)


def _broken_qparams(qp: dict, hidden: int, skip_layer: int, what: str) -> dict:
    """A copy of ``qp`` with the skip layer's x_enc rows zeroed (``skip``)
    or the fs head's sigma column dropped (``sigma``)."""
    bad = {**qp, "trunk": [dict(lyr) for lyr in qp["trunk"]], "fs": dict(qp["fs"])}
    if what == "skip":
        i = next(i for i in range(1, len(bad["trunk"])) if is_skip(i - 1, skip_layer))
        bad["trunk"][i]["wq"] = bad["trunk"][i]["wq"].clone()
        bad["trunk"][i]["wq"][hidden:] = 0
    else:
        for key in ("wq", "scale", "b"):
            bad["fs"][key] = bad["fs"][key].clone()
            bad["fs"][key][..., hidden] = 0
    return bad


def _errs(got: tuple, want: tuple) -> dict:
    d_rgb, d_w = (got[0] - want[0]).abs(), (got[1] - want[1]).abs()
    return {"rgb_max": d_rgb.max().item(), "rgb_mean": d_rgb.mean().item(),
            "w_max": d_w.max().item(), "w_mean": d_w.mean().item()}


def _miss(errs: dict) -> float:
    """How far errors are beyond K4's gates (1 = at the gate)."""
    return max(errs["rgb_max"] / K4_TOL_MAX, errs["w_max"] / K4_TOL_MAX,
               errs["rgb_mean"] / K4_TOL_MEAN, errs["w_mean"] / K4_TOL_MEAN)


def phase_k4(card: str) -> dict:
    """K4 vs render_rays_reference_quant at full width: B=4096 (one 64x64
    pose) with S=64, 160 (the proposal fine pass) and 192, a ragged B
    (several rays per block, a part-filled last block), and the chunk the
    server launches it on (B=16384 rays of a 128x128 pose, S=64 coarse and
    192 fine); two broken packs at S=192 must miss the gates by 10x."""
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(4)
    mlp = full_mlp(dev, 4)
    qp = _calibrated_qparams(mlp, dev)
    rays = {}
    for size in (64, 128):
        o, d = get_rays(size, size, 1.2 * size, pose_spherical(30.0, -30.0, 4.0), device=dev)
        rays[size * size] = (o.reshape(-1, 3).contiguous(), d.reshape(-1, 3).contiguous())
    report = {"max_abs_err": 0.0}
    for b, s in ((4096, 64), (4096, 160), (4096, 192), (1001, 24), (16384, 64), (16384, 192)):
        origins, dirs = rays[16384 if b > 4096 else 4096]
        o, d = origins[:b].contiguous(), dirs[:b].contiguous()
        t = generate_t_vals(2.0, 6.0, (b,), s, "stratified", generator=gen).to(dev).contiguous()
        args = (qp, o, d, t)
        got = k4.render_rays_fused_quant(*args)
        torch.cuda.synchronize()
        want = k4.render_rays_reference_quant(*args)
        errs = _errs(got, want)
        finite = bool(torch.isfinite(got[0]).all() and torch.isfinite(got[1]).all())
        fields = {}
        if s == 192:
            for what in ("skip", "sigma"):
                bad = _broken_qparams(qp, mlp.hidden_dim, mlp.skip_layer, what)
                fields[f"miss_{what}_broken"] = _miss(_errs(k4.launch_k4(bad, o, d, t, 10, 4, 4),
                                                            want))
        if b in (4096, 16384):
            bnd = k4_bound(mlp, b, s)
            fields.update(ms=cuda_ms(lambda: k4.render_rays_fused_quant(*args)),
                          plain_ms=cuda_ms(lambda: k4.render_rays_reference_quant(*args)),
                          bound_ms=bnd[0], bound_by=bnd[1])
            key = f"b{b}_s{s}"
            report[f"ms_{key}"], report[f"plain_ms_{key}"] = fields["ms"], fields["plain_ms"]
            report[f"bound_{key}"] = bnd
        say("k4", B=b, S=s, **errs, tol_max=K4_TOL_MAX, tol_mean=K4_TOL_MEAN, finite=finite,
            **fields, card=card)
        if not finite:
            raise RuntimeError(f"K4 produced non-finite values at B={b}, S={s}")
        if _miss(errs) > 1.0:
            raise RuntimeError(f"K4 disagrees with the plain version at B={b}, S={s}: {errs}")
        for what in ("skip", "sigma"):
            if s == 192 and fields[f"miss_{what}_broken"] < 10.0:
                raise RuntimeError(f"K4's gates cannot see a broken {what} pack: {fields}")
        report["max_abs_err"] = max(report["max_abs_err"], errs["rgb_max"], errs["w_max"])
    desc = k4.kernel_pack(qp, dev).desc
    for b in (4096, 16384):
        for s in (64, 192):
            key = f"library_ms_b{b}_s{s}"
            report[key] = library_products_ms(desc, b * s, torch.int8, dev)
            say("k4_library", B=b, S=s, library_ms=report[key], card=card)
    return report


def _get(url: str) -> tuple[bytes, float]:
    t0 = time.perf_counter()
    with urllib.request.urlopen(url, timeout=300) as resp:
        body = resp.read()
    return body, time.perf_counter() - t0


def phase_serve(card: str, tmp: str) -> dict:
    """Serve random weights at full width over HTTP; returns the launches
    the requests made."""
    cfg = load_config(CONFIG)
    ckpt = os.path.join(tmp, "random.ckpt.npz")
    save_params_npz(ckpt, random_params(cfg, seed=0), cfg,
                    scene={"near": 2.0, "far": 6.0})
    service = RenderService(cfg, ckpt, device="cuda")
    server = serve(service, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    size, chunk = 200, 16384
    n_chunks = -(-size * size // chunk)
    requests = [("rgb", 30.0), ("rgb", 120.0), ("depth", 30.0)]
    try:
        body, _ = _get(f"{base}/healthz")
        if body != b"ok":
            raise RuntimeError(f"/healthz answered {body!r}")
        reset_counts()  # count only the main path's launches from here
        for map_name, theta in requests:
            before = k1.launches
            png, seconds = _get(
                f"{base}/render?theta={theta}&phi=-30&radius=4&width={size}"
                f"&height={size}&chunk={chunk}&map={map_name}"
            )
            grew = k1.launches - before
            img = decode_png(png)
            shape = (size, size, 3) if map_name == "rgb" else (size, size)
            say("serve", map=map_name, theta=theta, latency_s=seconds,
                shape=list(img.shape), png_bytes=len(png), k1_launches=grew,
                std=float(img.std()), card=card)
            if img.shape != shape:
                raise RuntimeError(f"/render {map_name}: shape {img.shape} != {shape}")
            if map_name == "rgb" and img.std() == 0:
                raise RuntimeError("/render rgb returned a constant image")
            if grew != 2 * n_chunks:
                raise RuntimeError(
                    f"K1 launched {grew} times for one frame, expected "
                    f"2 x {n_chunks} chunks"
                )
        launches = counts()
        stats = json.loads(_get(f"{base}/stats")[0])
        say("stats", **stats)
        if stats["requests"] != len(requests):
            raise RuntimeError(f"/stats counts {stats['requests']} requests")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)

    # The served path on the card (K1) against the plain path on the CPU,
    # same checkpoint, on a small frame.
    pose = pose_spherical(30.0, -30.0, 4.0)
    gpu = service.trainer.render_image(pose, 24, 24, 28.8)
    cpu = Trainer(service.cfg, 2.0, 6.0, device="cpu").restore(ckpt)
    ref = cpu.render_image(pose, 24, 24, 28.8)
    d_rgb = float(np.abs(gpu["rgb"] - ref["rgb"]).max())
    d_depth = float(np.abs(gpu["depth"] - ref["depth"]).max())
    say("frame_vs_plain", size=24, rgb_max=d_rgb, depth_max=d_depth,
        tol_rgb=FRAME_TOL_RGB, tol_depth=FRAME_TOL_DEPTH)
    if not (np.isfinite(gpu["rgb"]).all() and np.isfinite(gpu["depth"]).all()):
        raise RuntimeError("non-finite frame from the card")
    if d_rgb > FRAME_TOL_RGB or d_depth > FRAME_TOL_DEPTH:
        raise RuntimeError("card frame disagrees with the plain CPU frame")
    return launches


def phase_serve_int8(card: str, tmp: str) -> dict:
    """The phase-6 checkpoint served with ``--quant int8``: the gate must
    pass, and every frame must render through K4 alone (two launches per
    chunk); one frame against the port's CPU int8 path on the same
    tables."""
    cfg = load_config(CONFIG)
    ckpt = os.path.join(tmp, "random.ckpt.npz")
    service = RenderService(cfg, ckpt, device="cuda", quant=True, quant_gate_db=QUANT_GATE_DB)
    say("int8_gate", psnr_db=service.quant_gate_psnr, gate_db=QUANT_GATE_DB,
        use_quant=service.use_quant, size=[cfg.height, cfg.width], card=card)
    if not (service.use_quant and service.trainer.quant_ready):
        raise RuntimeError(f"the int8 gate failed: {service.quant_gate_psnr} dB")
    server = serve(service, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    size, chunk = 200, 16384
    n_chunks = -(-size * size // chunk)
    requests = [("rgb", 30.0), ("rgb", 120.0), ("depth", 30.0)]
    try:
        reset_counts()  # count only the main path's launches from here
        for map_name, theta in requests:
            before = counts()
            png, seconds = _get(
                f"{base}/render?theta={theta}&phi=-30&radius=4&width={size}"
                f"&height={size}&chunk={chunk}&map={map_name}"
            )
            grew = {k: v - before[k] for k, v in counts().items()}
            img = decode_png(png)
            shape = (size, size, 3) if map_name == "rgb" else (size, size)
            say("serve_int8", map=map_name, theta=theta, latency_s=seconds,
                shape=list(img.shape), png_bytes=len(png), launches=grew,
                std=float(img.std()), card=card)
            if img.shape != shape:
                raise RuntimeError(f"/render {map_name}: shape {img.shape} != {shape}")
            if map_name == "rgb" and img.std() == 0:
                raise RuntimeError("/render rgb returned a constant image")
            if grew != dict(ZERO, k4=2 * n_chunks):
                raise RuntimeError(f"an int8 frame launched {grew}, expected "
                                   f"2 x {n_chunks} K4 launches and nothing else")
        launches = counts()
        stats = json.loads(_get(f"{base}/stats")[0])
        say("stats_int8", **stats)
        if stats["quant"] != "int8" or stats["requests"] != len(requests):
            raise RuntimeError(f"/stats: {stats}")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)

    # One served frame on the card against the plain int8 path on the CPU,
    # same tables, on every 40th ray.
    gpu = service.trainer
    origins, dirs = gpu.pose_rays(pose_spherical(30.0, -30.0, 4.0), size, size, 240.0)
    out = gpu.render_rays(origins, dirs, quant=True)
    idx = torch.arange(0, origins.shape[0], 40)
    cpu = Trainer(cfg, 2.0, 6.0, device="cpu").restore(ckpt).install_quant(gpu.qparams)
    ref = cpu.render_rays(origins[idx].cpu(), dirs[idx].cpu(), quant=True)
    errs, bad = {}, []
    for k in sorted(ref):
        got = out[k][idx.numpy()]
        if not np.isfinite(out[k]).all():
            bad.append(f"{k}: non-finite")
            continue
        errs[k] = float(np.abs(got - ref[k]).max())
        tol = FRAME_TOL_RGB if k.startswith("rgb") else FRAME_TOL_DEPTH
        if errs[k] > tol:
            bad.append(f"{k}: {errs[k]} > {tol}")
    say("int8_frame_vs_plain", size=size, rays_checked=len(idx), max_abs_err=errs,
        tol_rgb=FRAME_TOL_RGB, tol_depth=FRAME_TOL_DEPTH, card=card)
    if len(errs) != 4 or bad:
        raise RuntimeError(f"the int8 frame disagrees with the CPU int8 path: {bad}")
    return launches


def phase_proposal_int8(card: str, trainer: Trainer, phase: str = "proposal_int8",
                        rec=None) -> dict:
    """Phase 7's proposal-trained state (or another ``trainer``): calibrate
    int8 tables on a 200x200 pose, then a 200x200 frame through the float
    proposal chain and one K4 fine pass per chunk (inside ``rec``'s block
    when given), at least ``QUANT_GATE_DB`` of the float frame."""
    pose = pose_spherical(30.0, -30.0, 4.0)
    trainer.quantize_for_inference(*trainer.pose_rays(pose, 200, 200, 240.0))
    reset_counts()
    with rec or contextlib.nullcontext():
        frame = trainer.render_image(pose, 200, 200, 240.0, quant=True)
    launches = counts()
    n_chunks = -(-200 * 200 // 16384)
    rgb = frame["rgb"]
    flt = trainer.render_image(pose, 200, 200, 240.0)["rgb"]
    psnr = frame_psnr(flt, rgb)
    say(phase, size=200, launches=launches, psnr_vs_float_db=psnr, gate_db=QUANT_GATE_DB,
        card=card)
    if launches != dict(ZERO, k4=n_chunks):
        raise RuntimeError(f"{phase}: the int8 frame launched {launches}, expected "
                           f"{n_chunks} K4 launches and nothing else")
    if not (np.isfinite(rgb).all() and np.isfinite(frame["depth"]).all()):
        raise RuntimeError(f"{phase}: non-finite frame")
    if rgb.shape != (200, 200, 3) or rgb.std() == 0:
        raise RuntimeError(f"{phase}: a constant frame")
    if not psnr >= QUANT_GATE_DB:
        raise RuntimeError(f"{phase}: the int8 frame reads {psnr} dB against the float "
                           f"frame, below the {QUANT_GATE_DB} dB gate")
    return launches


def _plain_render_pass(cfg):
    def plain_pass(mlp, o, d, t, weights_grad):
        rgb, w = k1.render_rays_reference(mlp, o, d, t, l_xyz=cfg.l_xyz,
                                          l_dir=cfg.l_dir, skip_layer=cfg.skip_layer)
        return rgb, w if weights_grad else w.detach()
    return plain_pass


class _ColumnScale(torch.nn.Module):
    """A parametrization: the weight times a column scale, under autograd."""

    def __init__(self, scale: torch.Tensor):
        super().__init__()
        self.register_buffer("scale", scale)

    def forward(self, w):
        return w * self.scale[None, :]


def _autograd_fold_grads(cfg, trainer, batch, draws) -> tuple[float, list]:
    """The plain parity step's loss and gradients (in ``params_of`` order)
    with the frequency-anneal window applied by autograd: on copies of the
    trainer's NeRF MLPs, each linear layer that reads the position encoding
    (``in_features`` its width, or the hidden width plus it for the skip
    concat) computes ``weight * s`` inside the loss.  Independent of
    ``make_grad_fn``'s in-place fold and of ``ops/freq_anneal.fold_scales``."""
    images, origins, dirs = batch
    window = freq_window(cfg.l_xyz, anneal_alpha(trainer.step, cfg.freq_anneal_steps),
                         device=images.device)
    skip = torch.cat([torch.ones(cfg.hidden_dim, device=images.device), window])
    models = {k: copy.deepcopy(m) for k, m in trainer.params.items()}
    order = params_of(models)
    for model in models.values():
        for layer in list(model.modules()):
            if isinstance(layer, torch.nn.Linear):
                scale = {window.numel(): window, skip.numel(): skip}.get(layer.in_features)
                if scale is not None:
                    parametrize.register_parametrization(layer, "weight",
                                                         _ColumnScale(scale))
    loss_fn = make_loss_fn(cfg, trainer.near, trainer.far,
                           render_pass=_plain_render_pass(cfg),
                           mlp_fn=lambda mlp, x, d: mlp(x, d))
    t_vals = draw_t_vals(cfg, trainer.near, trainer.far, images.shape[:-1], images.device,
                         noise=draws["t"])
    loss, _ = loss_fn(models, images, origins, dirs, t_vals, trainer.step, None, draws["pdf"])
    loss.backward()
    return float(loss.detach()), [p.grad for p in order]


def _grads_kernel_vs_plain(cfg, trainer, batch, noise_shapes, seed, autograd_fold=False):
    """One step's gradients through ``make_grad_fn`` (with the
    frequency-anneal fold at the trainer's step) on the kernel path and on
    the plain path (the plain K1 for the render passes, the plain MLP for
    K5), with the same draws; with ``autograd_fold`` (a parity step) the
    plain path folds by autograd instead (:func:`_autograd_fold_grads`).
    Returns (loss_kernel, loss_plain), the per-leaf relative L2 by model,
    the max |diff| and the kernel path's gradients by model."""
    b = cfg.batch_size
    gen = torch.Generator(device="cuda").manual_seed(seed)
    draws = {"t": torch.rand((b, cfg.ns_coarse), generator=gen, device="cuda")}
    noise = [torch.rand(s, generator=gen, device="cuda") for s in noise_shapes]
    if cfg.train_sampler == "proposal":
        draws["chain"] = noise
        if aux_samples(cfg, trainer.step):
            draws["aux"] = torch.rand((b, aux_samples(cfg, trainer.step)), generator=gen,
                                      device="cuda")
    else:
        draws["pdf"] = noise[0]
    params = params_of(trainer.params)
    grads, losses = [], []
    for plain in (False, True):
        if plain and autograd_fold:
            loss, plain_grads = _autograd_fold_grads(cfg, trainer, batch, draws)
            grads.append(plain_grads)
            losses.append(loss)
            continue
        grad_fn = make_grad_fn(cfg, trainer.near, trainer.far,
                               render_pass=_plain_render_pass(cfg) if plain else None,
                               mlp_fn=(lambda mlp, x, d: mlp(x, d)) if plain else None)
        loss, _ = grad_fn(trainer.state, batch, draws)
        grads.append([p.grad.clone() for p in params])
        losses.append(float(loss.detach()))
    for p in params:
        p.grad = None
    by_model, kernel, i = {}, {}, 0
    for name in sorted(trainer.params):
        k = len(list(trainer.params[name].parameters()))
        by_model[name] = [_rel_l2(a, c) for a, c in zip(grads[0][i:i + k], grads[1][i:i + k])]
        kernel[name] = grads[0][i:i + k]
        i += k
    max_abs = max(float((a - c).abs().max()) for a, c in zip(*grads))
    del grads
    torch.cuda.empty_cache()
    return losses, by_model, max_abs, kernel


def _train_steps(trainer, batch, steps, per_step: dict, step_fn=None) -> dict:
    """``steps`` train steps (``trainer.train_step``, or ``step_fn(state,
    batch, draws, generator)`` on the trainer's state) with the counters
    reset just before; each must launch exactly ``per_step``."""
    reset_counts()
    step_ms, loss_curve, peak = [], [], 0
    for i in range(steps):
        before = counts()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if step_fn is None:
            metrics = trainer.train_step(batch)
        else:
            metrics = step_fn(trainer.state, batch, None, trainer.generator)
        loss_curve.append(float(metrics["loss"]))  # synchronises
        step_ms.append((time.perf_counter() - t0) * 1e3)
        peak = max(peak, torch.cuda.max_memory_allocated() - base)
        grew = {k: v - before[k] for k, v in counts().items()}
        if grew != per_step:
            raise RuntimeError(f"step {i} launched {grew}, expected {per_step}")
    warm = statistics.median(step_ms[2:]) if steps > 2 else statistics.median(step_ms)
    return {"launches": counts(), "loss_curve": loss_curve, "step_ms": step_ms,
            "median_step_ms": warm, "rays_per_s": trainer.cfg.batch_size / (warm / 1e3),
            "peak_step_mib": peak / 2**20}


def _eval_and_frame(trainer, batch, what: str) -> tuple[dict, dict]:
    """``evaluate`` and a 200x200 frame, counted as forward-only launches."""
    reset_counts()
    ev = trainer.evaluate([batch])
    frame = trainer.render_image(pose_spherical(30.0, -30.0, 4.0), 200, 200, 240.0)
    rgb = frame["rgb"]
    if not all(np.isfinite(v) for v in ev.values()):
        raise RuntimeError(f"{what}: non-finite eval metrics {ev}")
    if not (np.isfinite(rgb).all() and np.isfinite(frame["depth"]).all()):
        raise RuntimeError(f"{what}: non-finite frame")
    if rgb.shape != (200, 200, 3) or rgb.std() == 0:
        raise RuntimeError(f"{what}: a constant frame")
    return ev, counts()


ZERO = {"k1_fwd": 0, "k1_train": 0, "k2": 0, "k3": 0, "k5_fwd": 0, "k5_bwd": 0, "k4": 0,
        "k6_fwd": 0, "k6_bwd": 0, "k7": 0, "k1_fwd_f32": 0, "k1_train_f32": 0, "k2_f32": 0,
        "k3_f32": 0, "k5_fwd_f32": 0, "k5_bwd_f32": 0, "k6_fwd_f32": 0, "k6_bwd_f32": 0}


def phase_train(card: str) -> tuple[list[dict], Trainer]:
    """The bench recipe's proposal trainer on the card (10 steps); returns
    the launch counts and the trainer."""
    cfg = bench_config()
    trainer = Trainer(cfg, 2.0, 6.0, device="cuda")
    batch = trainer.put_batch(bench_batch(cfg.batch_size))
    losses, by_model, max_abs, _ = _grads_kernel_vs_plain(
        cfg, trainer, batch, [(cfg.batch_size, cfg.ns_fine)], seed=2)
    rel = max(max(v) for v in by_model.values())
    say("train_grads_vs_plain", loss_kernel=losses[0], loss_plain=losses[1],
        max_abs_err=max_abs, max_rel_l2=rel, tol_rel=STEP_TOL_REL, card=card)
    if rel > STEP_TOL_REL:
        raise RuntimeError(f"kernel-path gradients disagree with the plain path: {rel}")
    run = _train_steps(trainer, batch, 10, dict(ZERO, k1_train=1, k2=1))
    ev, after = _eval_and_frame(trainer, batch, "proposal")
    say("train", steps=10, **run, eval=ev, eval_frame_launches=after, card=card)
    if not run["loss_curve"][-1] < run["loss_curve"][0]:
        raise RuntimeError(f"the loss did not fall: {run['loss_curve']}")
    if run["peak_step_mib"] > STEP_PEAK_MIB:
        raise RuntimeError(f"a proposal step peaked at {run['peak_step_mib']} MiB")
    return [run["launches"], after], trainer


def phase_parity(card: str, stop: bool, tmp: str) -> tuple[list[dict], str | None]:
    """The coarse+fine parity step at lego_batch_h256_tpu widths (batch
    4096, 64 + 128): with STOP_PDF_GRADIENT 20 steps over K1/K2, then
    evaluate, a frame and a checkpoint; without it 5 steps over K5."""
    cfg = parity_config(stop_pdf_gradient=stop)
    trainer = Trainer(cfg, 2.0, 6.0, device="cuda")
    for m in trainer.params.values():
        randomize_biases_(m, torch.Generator().manual_seed(3))
    batch = trainer.put_batch(bench_batch(cfg.batch_size))
    losses, by_model, max_abs, _ = _grads_kernel_vs_plain(
        cfg, trainer, batch, [(cfg.batch_size, cfg.ns_fine)], seed=4)
    rel_fine, rel_coarse = max(by_model["fine"]), max(by_model["coarse"])
    tol_coarse = STEP_TOL_REL if stop else PDF_COARSE_TOL_REL
    say("parity_grads_vs_plain", stop_pdf_gradient=stop, loss_kernel=losses[0],
        loss_plain=losses[1], max_abs_err=max_abs, max_rel_l2_fine=rel_fine,
        max_rel_l2_coarse=rel_coarse, rel_l2_coarse_by_leaf=by_model["coarse"],
        tol_rel_fine=STEP_TOL_REL, tol_rel_coarse=tol_coarse, card=card)
    if not (rel_fine <= STEP_TOL_REL and rel_coarse <= tol_coarse):
        raise RuntimeError(f"kernel-path gradients disagree with the plain path: "
                           f"fine {rel_fine}, coarse {rel_coarse}")
    steps = 20 if stop else 5
    per_step = dict(ZERO, k1_train=2, k2=2) if stop else dict(ZERO, k5_fwd=2, k5_bwd=2)
    run = _train_steps(trainer, batch, steps, per_step)
    name = "parity_train" if stop else "parity_train_pdf_grad"
    if not all(np.isfinite(x) for x in run["loss_curve"]):
        raise RuntimeError(f"{name}: non-finite losses {run['loss_curve']}")
    if stop and not run["loss_curve"][-1] < run["loss_curve"][0]:
        raise RuntimeError(f"{name}: the loss did not fall: {run['loss_curve']}")
    if run["peak_step_mib"] > STEP_PEAK_MIB:
        raise RuntimeError(f"{name}: a step peaked at {run['peak_step_mib']} MiB")
    if not stop:
        say(name, steps=steps, **run, card=card)
        return [run["launches"]], None
    ev, after = _eval_and_frame(trainer, batch, name)
    say(name, steps=steps, **run, eval=ev, eval_frame_launches=after, card=card)
    ckpt = os.path.join(tmp, "parity.ckpt.npz")
    trainer.save(ckpt, scene={"near": 2.0, "far": 6.0})
    return [run["launches"], after], ckpt


def phase_full_render(card: str, ckpt: str) -> dict:
    """A 200x200 frame with full=True through K5 (two launches per chunk),
    all eight maps held against the port's CPU path on a strided subset of
    its rays (rays render independently)."""
    cfg = parity_config()
    gpu = Trainer(cfg, 2.0, 6.0, device="cuda").restore(ckpt)
    origins, dirs = gpu.pose_rays(pose_spherical(30.0, -30.0, 4.0), 200, 200, 240.0)
    chunk = 16384
    reset_counts()
    out = gpu.render_rays(origins, dirs, chunk=chunk, full=True)
    launches = counts()
    n_chunks = -(-origins.shape[0] // chunk)
    expected = dict(ZERO, k5_fwd=2 * n_chunks)
    if launches != expected:
        raise RuntimeError(f"the full render launched {launches}, expected {expected}")
    idx = torch.arange(0, origins.shape[0], 40)
    cpu = Trainer(cfg, 2.0, 6.0, device="cpu").restore(ckpt)
    ref = cpu.render_rays(origins[idx].cpu(), dirs[idx].cpu(), full=True)
    tols = {"rgb": FRAME_TOL_RGB, "depth": FRAME_TOL_DEPTH, "weights": FRAME_TOL_WEIGHTS,
            "preds": K5_PREDS_MAX}
    errs, bad = {}, []
    for k in sorted(ref):
        got = out[k][idx.numpy()]
        if got.shape != ref[k].shape or not np.isfinite(out[k]).all():
            bad.append(f"{k}: shape {got.shape} vs {ref[k].shape} or non-finite")
            continue
        errs[k] = float(np.abs(got - ref[k]).max())
        tol = tols.get(k, tols.get(k.split("_")[0]))
        if errs[k] > tol:
            bad.append(f"{k}: {errs[k]} > {tol}")
    say("full_render", size=200, chunks=n_chunks, launches=launches, rays_checked=len(idx),
        max_abs_err=errs, tolerances=tols, keys=sorted(out), card=card)
    if len(out) != 8 or bad:
        raise RuntimeError(f"the full render disagrees with the CPU path: {bad} {sorted(out)}")
    return launches


def _held_between(fn) -> tuple[int, tuple]:
    """Device bytes allocated by ``fn()`` and still held when it returns
    (its outputs and what its autograd graph saved), and its result."""
    torch.cuda.synchronize()
    before = exp_train_paths.requested_bytes()
    out = fn()
    torch.cuda.synchronize()
    return exp_train_paths.requested_bytes() - before, out


def phase_k3(card: str) -> dict:
    """K3 against K2 on the same K1 predictions, bit for bit; at S=160 also
    against autograd of the plain K1, with a broken K3 (its encode one
    octave short: l_xyz 9, zeros in the top octave's columns); the memory
    each backward mode holds between forward and backward."""
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(6)
    mlp = full_mlp(dev, 6)
    params = list(mlp.parameters())
    _, origins, dirs = (torch.as_tensor(x, device=dev) for x in bench_batch(4096))
    report = {}
    for b, s in ((4096, 64), (4096, 160), (4096, 192), (1001, 24)):
        o, d = origins[:b].contiguous(), dirs[:b].contiguous()
        t = generate_t_vals(2.0, 6.0, (b,), s, "stratified", generator=gen).to(dev).contiguous()
        g_rgb = (torch.randn((b, 3), generator=gen) * 1e-3).to(dev)
        g_w = (torch.randn((b, s), generator=gen) * 1e-3).to(dev)
        with torch.no_grad():
            _, _, x_enc, preds = k1.launch_k1(mlp, o, d, t, 10, 4, train=True)
            _, _, none, preds_only = k1.launch_k1(mlp, o, d, t, 10, 4, train=True,
                                                 emit_xenc=False)
        if none is not None or not torch.equal(preds, preds_only):
            raise RuntimeError("K1 with predictions only wrote other predictions")
        equal = {}
        for tag, gw in (("with_gw", g_w), ("without_gw", None)):
            with torch.no_grad():
                _, ws2 = k1.launch_rows(k1._ROWS_K2, mlp, t, preds, g_rgb, gw, 10, 4,
                                        x_res=x_enc, dirs=d)
                _, ws3 = k1.launch_rows(k1._ROWS_K3, mlp, t, preds_only, g_rgb, gw, 10, 4,
                                        origins=o, dirs=d)
                torch.cuda.synchronize()
            equal[tag] = bool(torch.equal(ws2.dw, ws3.dw) and torch.equal(ws2.db, ws3.db))
            equal[f"{tag}_max_abs"] = float(max((ws2.dw - ws3.dw).abs().max(),
                                                (ws2.db - ws3.db).abs().max()))
            del ws2, ws3
        fields = {}
        if (b, s) == (4096, 160):
            with torch.enable_grad():
                rgb_p, w_p = k1.render_rays_reference(mlp, o, d, t)
            want = list(torch.autograd.grad([rgb_p, w_p], params, [g_rgb, g_w],
                                            retain_graph=True))
            with torch.no_grad():
                got = k1.launch_k3(mlp, o, d, t, preds_only, g_rgb, g_w, 10, 4)
                fwd, wsb = k1.launch_rows(k1._ROWS_K3, mlp, t, preds_only, g_rgb, g_w, 9, 4,
                                          origins=o, dirs=d)
                broken = k1.unpack_grads(mlp, fwd, wsb.layout, wsb.dw, wsb.db)
                del wsb
            max_abs, rel = _leaf_errors(got, want)
            _, rel_broken = _leaf_errors(broken, want)
            with torch.no_grad():
                k3_ms = cuda_ms(lambda: k1.launch_k3(mlp, o, d, t, preds_only, g_rgb, g_w,
                                                     10, 4))
                k2_ms = cuda_ms(lambda: k1.launch_k2(mlp, x_enc, d, t, preds, g_rgb, g_w,
                                                     10, 4))
            plain_ms = cuda_ms(lambda: torch.autograd.grad(
                [rgb_p, w_p], params, [g_rgb, g_w], retain_graph=True))
            del rgb_p, w_p
            bnd = k3_bound(mlp, b, s)
            fields = dict(max_abs_err=max_abs, max_rel_l2=rel, tol_rel=K2_TOL_REL,
                          rel_l2_top_octave_dropped=rel_broken, ms=k3_ms, k2_ms=k2_ms,
                          plain_ms=plain_ms, bound_ms=bnd[0], bound_by=bnd[1])
            report.update(max_abs_err=max_abs, ms=k3_ms, plain_ms=plain_ms, bound=bnd)
        if b == 4096 and s in (64, 192):
            held = {}
            for mode in k1.BWD_MODES:
                def fwd_pass(mode=mode):
                    return k1.render_rays_fused(mlp, o, d, t, bwd_mode=mode)
                torch.autograd.grad([fwd_pass()[0].sum()], params)  # packs built
                held[mode], (rgb, _) = _held_between(fwd_pass)
                torch.autograd.grad([rgb.sum()], params)
                del rgb
            fields.update(held_bytes_recompute=held["recompute"],
                          held_bytes_residual=held["residual"],
                          held_bound_bytes=b * (s * 20 + 40) + 2**20)
            report[f"held_s{s}"] = held
        say("k3", B=b, S=s, k2_bit_equal=equal, **fields, card=card)
        if not (equal["with_gw"] and equal["without_gw"]):
            if fields.get("max_rel_l2", 0.0) > K2_TOL_REL:
                raise RuntimeError(f"K3 disagrees with K2 and with the plain backward at "
                                   f"B={b}, S={s}: {equal} {fields}")
            raise RuntimeError(f"K3's dW/db are not K2's bit for bit at B={b}, S={s}: {equal}")
        if fields.get("max_rel_l2", 0.0) > K2_TOL_REL:
            raise RuntimeError(f"K3 disagrees with the plain backward: {fields}")
        if "rel_l2_top_octave_dropped" in fields and \
                fields["rel_l2_top_octave_dropped"] < 10 * K2_TOL_REL:
            raise RuntimeError(f"the gate cannot see K3's encode one octave short: {fields}")
        if "held_bytes_recompute" in fields and \
                fields["held_bytes_recompute"] > fields["held_bound_bytes"]:
            raise RuntimeError(f"K3's forward holds more than its bound: {fields}")
        del x_enc, preds, preds_only
    torch.cuda.empty_cache()
    return report


def _k6_inputs(dev, gen, o, d, s, per_sample_dirs: bool):
    """Stratified t, the bf16 position encodings of the rays' points and the
    direction encodings: of the rays (``per_sample_dirs`` false) or of a
    random unit direction per sample, so that a kernel reading them per ray
    cannot pass."""
    b = o.shape[0]
    t = generate_t_vals(2.0, 6.0, (b,), s, "stratified", generator=gen).to(dev).contiguous()
    points, dirs_s = sample_rays(o, d, t)
    if per_sample_dirs:
        dirs_s = torch.randn((b, s, 3), generator=gen).to(dev)
        dirs_s = dirs_s / dirs_s.norm(dim=-1, keepdim=True)
    x_enc = encode_position(points, 10).to(torch.bfloat16).contiguous()
    d_enc = encode_position(dirs_s, 4).to(torch.bfloat16).contiguous()
    return t, x_enc, d_enc


def phase_k6(card: str) -> dict:
    """K6 forward and backward against their plain versions (per-sample
    directions), a K6 fed per-ray direction encodings against the gates, a
    loss on the weights, and K6 against K1 on the same rays."""
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(7)
    mlp = full_mlp(dev, 7)
    params = list(mlp.parameters())
    images, origins, dirs = (torch.as_tensor(x, device=dev) for x in bench_batch(4096))
    report = {"fwd_max_abs_err": 0.0, "bwd_max_abs_err": 0.0}
    for b, s in ((4096, 64), (4096, 192), (1001, 24)):
        o, d = origins[:b].contiguous(), dirs[:b].contiguous()
        t, x_enc, d_enc = _k6_inputs(dev, gen, o, d, s, per_sample_dirs=True)
        with torch.no_grad():
            got = k1.apply_nerf_render_fused(mlp, x_enc, d_enc, t)
            torch.cuda.synchronize()
            want = k1.apply_nerf_render_reference(mlp, x_enc, d_enc, t)
            per_ray = d_enc[:, :1].expand(-1, s, -1).contiguous()
            broken = k1.apply_nerf_render_fused(mlp, x_enc, per_ray, t)
        errs = _errs(got, want)
        miss = max(errs["rgb_max"] / TOL_MAX, errs["w_max"] / TOL_MAX,
                   errs["rgb_mean"] / TOL_MEAN, errs["w_mean"] / TOL_MEAN)
        _e = _errs(broken, want)
        miss_broken = max(_e["rgb_max"] / TOL_MAX, _e["rgb_mean"] / TOL_MEAN)
        g_rgb = (torch.randn((b, 3), generator=gen) * 1e-3).to(dev)
        with torch.no_grad():
            _, _, preds = k1.launch_k6_fwd(mlp, x_enc, d_enc, t, train=True)
            grads = k1.launch_k6_bwd(mlp, x_enc, d_enc, t, preds, g_rgb)
        want_g = k1.apply_nerf_render_reference_vjp(mlp, x_enc, d_enc, t, g_rgb)
        max_abs, rel = _leaf_errors(grads, want_g)
        finite = bool(torch.isfinite(got[0]).all() and torch.isfinite(got[1]).all()) and \
            all(bool(torch.isfinite(g).all()) for g in grads)
        fields = {}
        if (b, s) == (4096, 192):
            # The weights carry no gradient: a loss on them adds nothing.
            target = images[:b]
            rgb, w = k1.apply_nerf_render_fused(mlp, x_enc, d_enc, t)
            g_rgb_only = torch.autograd.grad([((rgb - target) ** 2).mean()], params)
            rgb, w = k1.apply_nerf_render_fused(mlp, x_enc, d_enc, t)
            g_both = torch.autograd.grad([((rgb - target) ** 2).mean() + (w ** 2).sum()],
                                         params)
            fields["weights_loss_adds_nothing"] = (not w.requires_grad) and all(
                torch.equal(a, c) for a, c in zip(g_rgb_only, g_both))
            # K6 against K1 on the same rays (direction encodings per ray).
            t1, x1, d1 = _k6_inputs(dev, gen, o, d, s, per_sample_dirs=False)
            with torch.no_grad():
                fields["vs_k1"] = _errs(k1.apply_nerf_render_fused(mlp, x1, d1, t1),
                                        k1.render_rays_fused(mlp, o, d, t1))
                fwd_ms = cuda_ms(lambda: k1.apply_nerf_render_fused(mlp, x_enc, d_enc, t))
                fwd_plain_ms = cuda_ms(
                    lambda: k1.apply_nerf_render_reference(mlp, x_enc, d_enc, t))
                bwd_ms = cuda_ms(lambda: k1.launch_k6_bwd(mlp, x_enc, d_enc, t, preds, g_rgb))
            with torch.enable_grad():
                rgb_p, _ = k1.apply_nerf_render_reference(mlp, x_enc, d_enc, t)
            bwd_plain_ms = cuda_ms(lambda: torch.autograd.grad([rgb_p], params, [g_rgb],
                                                               retain_graph=True))
            del rgb_p
            fwd_bnd, bwd_bnd = k6_bounds(mlp, b, s)
            fields.update(fwd_ms=fwd_ms, fwd_plain_ms=fwd_plain_ms, fwd_bound_ms=fwd_bnd[0],
                          bwd_ms=bwd_ms, bwd_plain_ms=bwd_plain_ms, bwd_bound_ms=bwd_bnd[0])
            report.update(fwd_ms=fwd_ms, fwd_plain_ms=fwd_plain_ms, fwd_bound=fwd_bnd,
                          bwd_ms=bwd_ms, bwd_plain_ms=bwd_plain_ms, bwd_bound=bwd_bnd)
        say("k6", B=b, S=s, **errs, tol_max=TOL_MAX, tol_mean=TOL_MEAN,
            miss_dirs_per_ray=miss_broken, grad_max_abs=max_abs, grad_max_rel_l2=rel,
            tol_rel=K2_TOL_REL, finite=finite, **fields, card=card)
        if not finite:
            raise RuntimeError(f"K6 produced non-finite values at B={b}, S={s}")
        if miss > 1.0:
            raise RuntimeError(f"K6's forward disagrees with the plain version: {errs}")
        if rel > K2_TOL_REL:
            raise RuntimeError(f"K6's backward disagrees with the plain one: {rel}")
        if miss_broken < 10.0:
            raise RuntimeError(f"the gates cannot see a K6 reading directions per ray: "
                               f"{miss_broken}")
        if fields.get("weights_loss_adds_nothing") is False:
            raise RuntimeError("a loss on K6's weights moved the gradients")
        report["fwd_max_abs_err"] = max(report["fwd_max_abs_err"], errs["rgb_max"],
                                        errs["w_max"])
        report["bwd_max_abs_err"] = max(report["bwd_max_abs_err"], max_abs)
        del x_enc, d_enc, preds, grads, want_g
    torch.cuda.empty_cache()
    return report


K7_TOL = 1e-3  # hard gate on any union value; the count above 1e-5 is reported


def phase_k7(card: str) -> dict:
    """K7 against the chain at its three main shapes, with adversarial rows:
    the gates, the float64 check, and call and device times beside the
    byte bound and the yardsticks."""
    report = {"max_abs_err": 0.0}
    for b, s, nf, sorted_u in exp_train_paths.K7_SHAPES:
        t, w = exp_train_paths.pdf_inputs(b, s, seed=b)
        w[0] = 0.0  # uniform pdf through the floor
        w[1] = 0.0
        w[1, s // 2] = 5.0  # a single spike: plateaus in the cdf
        w[2] = 0.0
        w[2, :2] = 1.0  # front-loaded mass
        t[3, s // 2:s // 2 + 4] = t[3, s // 2]  # a repeated coarse value, and the
        w[3] = 0.0  # mass between its equal midpoints: draws tie with it
        w[3, s // 2 + 1:s // 2 + 3] = 1.0
        u = exp_train_paths.k7_u(b, nf, sorted_u)
        got = k7.sample_pdf_union(t, w, nf, u)
        torch.cuda.synchronize()
        same_bits = bool(torch.equal(k7.sample_pdf_union(t, w, nf, u), got))
        want = k7.sample_pdf_union_reference(t, w, nf, u)
        errs = exp_train_paths.union_errors(got, want)
        exact = k7.sample_pdf_union_float64(t, w, nf, u)
        vs64 = {"k7": exp_train_paths.union_errors(got.double(), exact),
                "chain": exp_train_paths.union_errors(want.double(), exact)}
        idx = torch.searchsorted(got, t).clamp(max=s + nf - 1)
        coarse_exact = bool(torch.equal(got.gather(1, idx), t))
        ascending = bool((got.diff(dim=-1) >= 0).all())
        ties = int((got[3] == t[3, s // 2]).sum()) - 4
        broken = exp_train_paths.union_errors(k7.launch_k7(t, w, nf, u, w_floor=0.0), want)
        times = exp_train_paths.k7_times(t, w, nf, u)
        bnd = k7_bound(b, s, nf, sorted_u)
        say("k7", B=b, S=s, NF=nf, u="sorted" if sorted_u else "eval", **errs, tol=K7_TOL,
            vs_float64=vs64, coarse_bit_exact=coarse_exact, ascending=ascending,
            same_bits=same_bits, draws_on_repeated_value=ties,
            miss_without_floor=broken["max_abs_err"] / K7_TOL, **times, bound_ms=bnd[0],
            bound_by=bnd[1], card=card)
        if not (coarse_exact and ascending and same_bits) or ties <= 0:
            raise RuntimeError(f"K7 lost a coarse value, is not ascending, changed between "
                               f"runs or drew nothing on the repeated value at B={b}, NF={nf}")
        if errs["max_abs_err"] > K7_TOL:
            raise RuntimeError(f"K7 disagrees with the chain at B={b}, NF={nf}: {errs}")
        if (vs64["k7"]["max_abs_err"] > vs64["chain"]["max_abs_err"]
                or vs64["k7"]["above_1e-5"] > vs64["chain"]["above_1e-5"]):
            raise RuntimeError(f"K7 is further from the float64 chain than the float32 chain "
                               f"at B={b}, NF={nf}: {vs64}")
        if broken["max_abs_err"] < 10 * K7_TOL:
            raise RuntimeError(f"the gate cannot see a K7 without the weight floor: {broken}")
        report["max_abs_err"] = max(report["max_abs_err"], errs["max_abs_err"])
        if "ms" not in report:
            # The render chunk stands for K7 in the kernel line, in device time:
            # a call of a few microseconds is timed mostly on the host.
            report.update(ms=times["device_ms"], plain_ms=times["chain_device_ms"], bound=bnd)
    return report


def phase_paths(card: str) -> list[dict]:
    """The parity step's three training paths: one step's gradients of
    paths c and a against path b on the same draws, then 5 steps of each
    with their launch counts and the memory each forward holds."""
    cfg = parity_config()
    per_step = {"b": dict(ZERO, k1_train=2, k2=2), "c": dict(ZERO, k1_train=2, k3=2),
                "a": dict(ZERO, k6_fwd=2, k6_bwd=2)}
    trainers = {n: exp_train_paths.make_trainer(cfg) for n in per_step}
    batch = trainers["b"].put_batch(bench_batch(cfg.batch_size))
    gen = torch.Generator(device="cuda").manual_seed(9)
    t_vals = draw_t_vals(cfg, 2.0, 6.0, (cfg.batch_size,), "cuda",
                         noise=torch.rand((cfg.batch_size, cfg.ns_coarse), generator=gen,
                                          device="cuda"))
    noise = torch.rand((cfg.batch_size, cfg.ns_fine), generator=gen, device="cuda")
    grads = {}
    for n, tr in trainers.items():
        loss_fn = make_loss_fn(cfg, 2.0, 6.0, render_pass=exp_train_paths.variant_pass(cfg, n))
        params = params_of(tr.params)
        loss, _ = loss_fn(tr.params, *batch, t_vals, 0, noise=noise)
        grads[n] = torch.autograd.grad([loss], params)
    c_equal = all(torch.equal(x, y) for x, y in zip(grads["c"], grads["b"]))
    rel = {n: max(_rel_l2(x, y) for x, y in zip(grads[n], grads["b"])) for n in ("c", "a")}
    say("paths_grads_vs_default", c_bit_equal_b=c_equal, max_rel_l2=rel, tol_rel=STEP_TOL_REL,
        card=card)
    del grads
    if not (c_equal or rel["c"] <= STEP_TOL_REL) or rel["a"] > STEP_TOL_REL:
        raise RuntimeError(f"a training path's gradients disagree with the default: {rel}")
    runs = []
    for n, tr in trainers.items():
        held = exp_train_paths.held_bytes(cfg, tr, batch, exp_train_paths.variant_pass(cfg, n))
        step_fn = make_train_step(cfg, 2.0, 6.0, render_pass=exp_train_paths.variant_pass(cfg, n))
        run = _train_steps(tr, batch, 5, per_step[n], step_fn=step_fn)
        say("paths_train", variant=n, steps=5, held_mb=held / 2**20, **run, card=card)
        if not all(np.isfinite(x) for x in run["loss_curve"]):
            raise RuntimeError(f"path {n}: non-finite losses {run['loss_curve']}")
        runs.append(run["launches"])
    torch.cuda.empty_cache()
    return runs


def phase_pdf_frame(card: str, ckpt: str) -> dict:
    """A 200x200 frame from the phase-8 checkpoint with K7 in place of the
    chain (one launch per chunk), against the engine's render."""
    cfg = parity_config()
    trainer = Trainer(cfg, 2.0, 6.0, device="cuda").restore(ckpt)
    origins, dirs = trainer.pose_rays(pose_spherical(30.0, -30.0, 4.0), 200, 200, 240.0)
    chunk = 16384
    reset_counts()
    outs = [exp_train_paths.render_rays_union(cfg, trainer.eval_params, origins[i:i + chunk],
                                              dirs[i:i + chunk])
            for i in range(0, origins.shape[0], chunk)]
    launches = counts()
    n_chunks = len(outs)
    expected = dict(ZERO, k1_fwd=2 * n_chunks, k7=n_chunks)
    render = make_render_fn(cfg, 2.0, 6.0)
    errs = {"rgb": 0.0, "depth": 0.0}
    with torch.no_grad():
        for i, got in zip(range(0, origins.shape[0], chunk), outs):
            want = render(trainer.eval_params, origins[i:i + chunk], dirs[i:i + chunk])
            for k in errs:
                errs[k] = max(errs[k], float((got[f"{k}_fine"] - want[f"{k}_fine"]).abs().max()))
    rgb = torch.cat([o["rgb_fine"] for o in outs])
    say("pdf_frame", size=200, chunks=n_chunks, launches=launches, rgb_max_abs_err=errs["rgb"],
        depth_max_abs_err=errs["depth"], tol_rgb=FRAME_TOL_RGB, tol_depth=FRAME_TOL_DEPTH,
        card=card)
    if launches != expected:
        raise RuntimeError(f"the K7 frame launched {launches}, expected {expected}")
    if not bool(torch.isfinite(rgb).all()) or float(rgb.std()) == 0.0:
        raise RuntimeError("the K7 frame is non-finite or constant")
    if errs["rgb"] > FRAME_TOL_RGB or errs["depth"] > FRAME_TOL_DEPTH:
        raise RuntimeError(f"the K7 frame disagrees with the engine's render: {errs}")
    return launches


class _Tee(io.TextIOBase):
    """Write to the real stdout and keep a copy (the CLI's epoch lines)."""

    def __init__(self, out):
        self.out, self.buf = out, io.StringIO()

    def write(self, text):
        self.buf.write(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def _clean(launches: dict) -> dict:
    """The kernel launches of a ``_cli`` count, without the batcher's."""
    return {k: v for k, v in launches.items() if k != "native_batches"}


def _cli(main, argv: list[str]) -> tuple[object, str, dict]:
    """One in-process CLI run with the counters set to 0 just before it:
    (what ``main`` returns, its stdout, the launches it made)."""
    tee = _Tee(sys.stdout)
    reset_counts()
    native_batcher.batches = 0
    with contextlib.redirect_stdout(tee):
        trainer = main(argv)
    launches = dict(counts(), native_batches=native_batcher.batches)
    return trainer, tee.buf.getvalue(), launches


def _expected_launches(cfg, prepare, epochs: int, evals: int, passes: int = 2,
                       train_passes=None) -> dict:
    """The launches of ``epochs`` epochs and ``evals`` evals by the CLI's
    own accounting: K1 in training mode and K2 ``train_passes(step)`` times
    per step (default ``passes``: the coarse and fine passes), the native
    batcher once per step; K1 forward ``passes`` times per eval batch (drop
    remainder) and per render chunk of the two panel views."""
    train_ds, val_ds, _, _ = prepare(cfg.height, cfg.width)
    steps = len(train_ds) // cfg.batch_size
    test_bs = cfg.test_batch_size or cfg.batch_size
    eval_batches = len(val_ds) // train_cli.resolve_eval_batch(test_bs, len(val_ds))
    chunks = min(2, val_ds.num_images) * math.ceil(cfg.height * cfg.width
                                                   / max(test_bs, 4096))
    train = sum(passes if train_passes is None else train_passes(i)
                for i in range(steps * epochs))
    return dict(ZERO, k1_train=train, k2=train, k1_fwd=passes * (eval_batches + chunks) * evals,
                native_batches=steps * epochs), steps


EPOCH_LINE = re.compile(r"^epoch (\d+)/\d+ loss=\S+ loss_coarse=\S+ psnr=\S+ "
                        r"\(([\d.]+) Krays/s, ([\d.]+) ms/step\)", re.M)


def _idle_share(trace_path: str) -> dict:
    """The device's idle share over a Chrome trace's window: one minus the
    union of its device intervals (kernels, copies, sets) over the span of
    all its events."""
    with open(trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    device = [(e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not device:
        raise RuntimeError(f"the profiler trace {trace_path} holds no device work")
    start = min(e["ts"] for e in events)
    end = max(e["ts"] + e["dur"] for e in events)
    busy = union_us(device)
    return {"window_ms": (end - start) / 1e3, "device_busy_ms": busy / 1e3,
            "idle_share": 1.0 - busy / (end - start), "device_events": len(device)}


def _write_blender_scene(root: str) -> None:
    """6 train and 2 val RGBA frames of 40x40 (an orange disk, soft-edged
    alpha, on a clear background) with ``transforms_*.json``."""
    y, x = np.mgrid[0:40, 0:40]
    for split, n in (("train", 6), ("val", 2)):
        os.makedirs(os.path.join(root, split))
        frames = []
        for i in range(n):
            theta = 360.0 * (i + 0.5 * (split == "val")) / 6
            r = np.hypot(x - 20 - 4 * math.cos(math.radians(theta)), y - 20)
            alpha = np.clip(14.0 - r, 0.0, 1.0)
            rgba = np.stack([0.9 + 0 * r, 0.45 + 0.3 * y / 40, 0.1 + 0 * r, alpha], -1)
            with open(os.path.join(root, split, f"r_{i}.png"), "wb") as f:
                f.write(encode_png((rgba * 255).astype(np.uint8)))
            frames.append({"file_path": f"./{split}/r_{i}",
                           "transform_matrix": pose_spherical(theta, -30.0, 4.0).tolist()})
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": 0.6911, "frames": frames}, f)


def _history_name(cfg) -> str:
    return (f"history_l{cfg.num_layers}_d{cfg.hidden_dim}"
            f"_n{cfg.ns_coarse + cfg.ns_fine}_ep{cfg.epochs}.json")


def _config_file(path: str, base: str = CONFIG, **changes) -> str:
    with open(base) as f:
        raw = json.load(f)
    raw.update(changes)
    with open(path, "w") as f:
        json.dump(raw, f)
    return path


def phase_train_cli(card: str, tmp: str) -> tuple[list[dict], str]:
    """Phase 19 (module docstring): the training CLI on the card, (a)-(e);
    returns the launches and (a)'s run directory."""
    cfg = load_config(CONFIG)
    run = os.path.join(tmp, "cli_run")
    base = ["--config", CONFIG, "--run-dir", run]
    # (a) three epochs at full width.
    cfg3 = dataclasses.replace(cfg, epochs=3)
    expected, steps = _expected_launches(cfg3, train_synthetic.prepare, 3, 3)
    trainer, out, launches = _cli(train_synthetic.main, base + ["--epochs", "3",
                                                                "--eval-every", "1"])
    epochs = [{"epoch": int(m[0]), "krays_per_s": float(m[1]), "step_ms": float(m[2])}
              for m in EPOCH_LINE.findall(out)]
    name = checkpoint_name(cfg3)
    hist_path = os.path.join(run, _history_name(cfg3))
    files = {f: os.path.exists(os.path.join(run, f))
             for f in (name, "best." + name, _history_name(cfg3),
                       os.path.join("images", "000.png"))}
    history = History.load(hist_path) if files[_history_name(cfg3)] else None
    say("train_cli_synthetic", steps_per_epoch=steps, epochs=epochs, launches=launches,
        expected=expected, files=files,
        losses=None if history is None else history.losses,
        val_psnrs=None if history is None else history.val["psnrs"],
        val_ssims=None if history is None else history.val["ssims"], card=card)
    if "batches: native batcher" not in out or "using numpy" in out:
        raise RuntimeError("train_cli (a): the native batcher did not feed the run")
    if launches != expected:
        raise RuntimeError(f"train_cli (a): launched {launches}, expected {expected}")
    if not all(files.values()) or len(epochs) != 3:
        raise RuntimeError(f"train_cli (a): files {files}, epoch lines {epochs}")
    if not (np.isfinite(history.losses).all() and history.losses[2] < history.losses[0]
            and history.val["psnrs"][2] > history.val["psnrs"][0]):
        raise RuntimeError(f"train_cli (a): loss {history.losses} or val PSNR "
                           f"{history.val['psnrs']} did not improve over 3 epochs")
    runs = [launches]
    del trainer
    torch.cuda.empty_cache()

    # (b) resume to 4 epochs, with a profiler window over 10 steps.
    profile_dir = os.path.join(tmp, "cli_profile")
    cfg4 = dataclasses.replace(cfg, epochs=4)
    expected, _ = _expected_launches(cfg4, train_synthetic.prepare, 1, 1)
    trainer, out, launches = _cli(train_synthetic.main, base + [
        "--resume", os.path.join(run, name), "--epochs", "4", "--eval-every", "1",
        "--profile", profile_dir, "--profile-steps", "10"])
    idle = _idle_share(os.path.join(profile_dir, "trace.json"))
    resumed = History.load(os.path.join(run, _history_name(cfg4)))
    epochs = [{"epoch": int(m[0]), "krays_per_s": float(m[1]), "step_ms": float(m[2])}
              for m in EPOCH_LINE.findall(out)]
    say("train_cli_resume", launches=launches, expected=expected, epochs=epochs,
        history_epochs=len(resumed.losses), adam_count=trainer.state.opt.count,
        profile_window_steps=10, **idle, card=card)
    if f"at step {3 * steps}" not in out or len(resumed.losses) != 4 \
            or trainer.state.opt.count != 4 * steps or trainer.step != 4 * steps:
        raise RuntimeError(f"train_cli (b): the resume did not continue at step {3 * steps}: "
                           f"history {len(resumed.losses)}, Adam {trainer.state.opt.count}")
    if launches != expected:
        raise RuntimeError(f"train_cli (b): launched {launches}, expected {expected}")
    runs.append(launches)
    del trainer
    torch.cuda.empty_cache()

    # (c) the entry point's default config: BatchNorm, plain MLP only.
    bn_cfg = load_config(os.path.join(os.path.dirname(CONFIG), "lego_batch_debug.json"))
    bn_run = os.path.join(tmp, "cli_bn")
    trainer, out, launches = _cli(train_synthetic.main, [
        "--run-dir", bn_run, "--epochs", "2"])
    bn_hist = History.load(os.path.join(bn_run, _history_name(
        dataclasses.replace(bn_cfg, epochs=2))))
    stats = trainer.bn_tree()
    moved = max(max(float(np.abs(layer["mean"]).max()), float(np.abs(layer["var"] - 1).max()))
                for tree in stats.values() for layer in [*tree["trunk"], tree["branch"]])
    say("train_cli_bn", config="lego_batch_debug.json", launches=launches,
        losses=bn_hist.losses, val_psnrs=bn_hist.val["psnrs"], stats_moved_max=moved,
        card=card)
    if any(v for k, v in launches.items() if k != "native_batches"):
        raise RuntimeError(f"train_cli (c): a BatchNorm run launched kernels: {launches}")
    if not (np.isfinite(bn_hist.losses).all() and bn_hist.losses[1] < bn_hist.losses[0]):
        raise RuntimeError(f"train_cli (c): the BN loss did not fall: {bn_hist.losses}")
    if not moved > 1e-4:
        raise RuntimeError(f"train_cli (c): the running statistics stayed at init: {moved}")
    runs.append(launches)
    del trainer

    # (d) a tiny Blender scene, written here, at full width.
    scene = os.path.join(tmp, "blender_scene")
    _write_blender_scene(scene)
    bl_config = _config_file(os.path.join(tmp, "blender.json"), BATCH_SIZE=1024,
                             HEIGHT=40, WIDTH=40, WITH_GCS=False)
    bl_cfg = dataclasses.replace(load_config(bl_config), epochs=1)
    expected, bl_steps = _expected_launches(
        bl_cfg, lambda h, w: train_blender.prepare(h, w, data_dir=scene, config=bl_cfg), 1, 1)
    bl_run = os.path.join(tmp, "cli_blender")
    trainer, out, launches = _cli(train_blender.main, [
        "--config", bl_config, "--data-dir", scene, "--run-dir", bl_run, "--epochs", "1"])
    bl_hist = History.load(os.path.join(bl_run, _history_name(bl_cfg)))
    say("train_cli_blender", frames="6 train + 2 val RGBA 40x40", steps=bl_steps,
        launches=launches, expected=expected, losses=bl_hist.losses,
        val_psnrs=bl_hist.val["psnrs"], card=card)
    if launches != expected or not np.isfinite(bl_hist.losses + bl_hist.val["psnrs"]).all():
        raise RuntimeError(f"train_cli (d): launched {launches} (expected {expected}), "
                           f"history {bl_hist.to_dict()}")
    runs.append(launches)
    del trainer
    torch.cuda.empty_cache()

    # (e) serve (a)'s run dir: best.*, one val view at the config's 100x100.
    service = RenderService(cfg, run, device="cuda")
    _, val_ds, _, _ = train_synthetic.prepare(cfg.height, cfg.width)
    thetas = np.linspace(0.0, 360.0, 12, endpoint=False)
    phis = np.random.default_rng(0).uniform(-40.0, -20.0, size=12)  # the scene's poses
    reset_counts()
    png = service.render_png(float(thetas[9]), float(phis[9]), 4.0, cfg.height, cfg.width)
    launches = counts()
    img = decode_png(png)
    served_psnr = frame_psnr(val_ds.image(0), img.astype(np.float32) / 255.0)
    best_val = max(History.load(hist_path).val["psnrs"])
    say("train_cli_serve", checkpoint=os.path.basename(service.checkpoint), launches=launches,
        shape=list(img.shape), psnr_vs_ground_truth=served_psnr, best_val_psnr=best_val,
        card=card)
    if not os.path.basename(service.checkpoint).startswith("best."):
        raise RuntimeError(f"train_cli (e): served {service.checkpoint}, not best.*")
    if launches != dict(ZERO, k1_fwd=2) or img.shape != (cfg.height, cfg.width, 3):
        raise RuntimeError(f"train_cli (e): launched {launches}, shape {img.shape}")
    if not served_psnr > best_val - 3.0:
        raise RuntimeError(f"train_cli (e): the served val view reads {served_psnr} dB "
                           f"against the run's best val PSNR {best_val}")
    runs.append(launches)
    return [_clean(r) for r in runs], run


def phase_visualization(card: str, tmp: str, run: str) -> None:
    """Phase 19b (module docstring): ``python -m
    nerf_keras_tpu_torch.visualization`` in-process on (19a)'s panels."""
    image_dir = os.path.join(run, "images")
    names = sorted(n for n in os.listdir(image_dir) if n.endswith(".png"))
    panels = []
    for name in names:
        with open(os.path.join(image_dir, name), "rb") as f:
            panels.append(decode_png(f.read()))
    distinct = sum(1 for i, p in enumerate(panels)
                   if i == 0 or not np.array_equal(p, panels[i - 1]))
    tee = _Tee(sys.stdout)
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        written = visualization.main(["--config", CONFIG, "--image-dir", image_dir,
                                      "--out", os.path.join(tmp, "training.mp4")])
    seconds = time.perf_counter() - t0
    launches = counts()
    back, durations, loop = read_gif(written)
    say("visualization", panels=len(panels), frames=len(back), durations_ms=durations,
        size=list(back[0].shape) if back else None, bytes=os.path.getsize(written),
        seconds=seconds, launches=launches, card=card)
    if not written.endswith(".gif") or f"video saved to {written}" not in tee.buf.getvalue():
        raise RuntimeError(f"visualization: wrote {written}")
    if len(back) != distinct or loop != 0 or launches != ZERO or \
            any(g.shape != panels[0].shape for g in back):
        raise RuntimeError(f"visualization: {len(back)} frames of {len(panels)} panels "
                           f"({distinct} distinct), loop {loop}, launched {launches}")


DISTILL_LINE = re.compile(r"distilled the proposal net: (\d+) steps of (\d+) points in "
                          r"([\d.]+) s, loss (\S+) -> (\S+)")
GATE_LINE = re.compile(r"\] (int8|proposal) gate (PASS|FAIL): (\S+) dB")
FRAME_MS = re.compile(r"frame \d+/\d+ \(([\d.]+) ms\)")


def _host_ms(fn, reps: int = 5) -> float:
    """Median host milliseconds of ``fn()`` after one warm-up; ``fn`` ends in
    a copy to the host, which waits for the card."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_infer_cli(card: str, tmp: str, run: str) -> list[dict]:
    """Phase 20 (module docstring): the evaluation and inference CLIs and
    the server with the distilled sampler and the artifact cache, on the
    run directory of ``train_cli`` (a), (a)-(f)."""
    cfg = load_config(CONFIG)
    views = 3  # the synthetic val split; 100x100 views are one chunk each
    cache = os.path.join(tmp, "a.infer.npz")
    base = ["--config", CONFIG, "--checkpoint", run, "--data", "synthetic",
            "--split", "val"]
    runs = []

    def evaluate(tag: str, *extra: str) -> tuple[dict, str, dict, float]:
        t0 = time.perf_counter()
        report, out, launches = _cli(eval_cli.run_evaluation, base + [
            "--out", os.path.join(tmp, f"eval_{tag}.json"),
            "--save-images", os.path.join(tmp, f"eval_{tag}")] + list(extra))
        launches = _clean(launches)
        runs.append(launches)
        return report, out, launches, time.perf_counter() - t0

    def expect(part: str, launches: dict, **want) -> None:
        if launches != dict(ZERO, **want):
            raise RuntimeError(f"infer_cli ({part}): launched {launches}, expected {want}")

    def pred(tag: str) -> np.ndarray:
        with open(os.path.join(tmp, f"eval_{tag}", "val_000_pred.png"), "rb") as f:
            return decode_png(f.read()).astype(np.float32) / 255.0

    # (a) float, against a random-weight checkpoint of the same config and
    # against the plain path on the CPU.
    rep_a, _, launches, seconds = evaluate("a")
    rnd_dir = os.path.join(tmp, "random_run")
    os.makedirs(rnd_dir)
    rnd_ckpt = os.path.join(rnd_dir, "random.ckpt.npz")
    save_params_npz(rnd_ckpt, random_params(cfg, seed=0), cfg,
                    scene={"near": 2.0, "far": 6.0, "focal": 1.2 * cfg.width})
    rep_rnd, _, rnd_launches = _cli(eval_cli.run_evaluation, [
        "--config", CONFIG, "--checkpoint", rnd_ckpt, "--out",
        os.path.join(tmp, "eval_random.json")])
    runs.append(_clean(rnd_launches))
    ckpt = resolve_checkpoint(run)
    _, val_ds, _, _ = train_synthetic.prepare(cfg.height, cfg.width)
    o, d = val_ds.image_rays(0)
    gpu = Trainer(cfg, 2.0, 6.0, device="cuda").restore(ckpt)
    full = gpu.render_rays(o, d, keys=("rgb_fine",))["rgb_fine"]
    view_ms = _host_ms(lambda: gpu.render_rays(o, d, keys=("rgb_fine",)))
    idx = np.arange(0, o.shape[0], 40)
    cpu = Trainer(cfg, 2.0, 6.0, device="cpu").restore(ckpt)
    ref = cpu.render_rays(o[idx], d[idx], keys=("rgb_fine",))["rgb_fine"]
    rgb_err = float(np.abs(full[idx] - ref).max())
    view0_psnr = frame_psnr(val_ds.image(0), full.reshape(cfg.height, cfg.width, 3))
    say("infer_cli_eval", part="a", launches=launches, seconds=seconds,
        view_ms=view_ms, mean=rep_a["mean"], views=rep_a["views"],
        random_mean=rep_rnd["mean"], view0_rgb_max_vs_cpu=rgb_err,
        rays_checked=len(idx), tol_rgb=FRAME_TOL_RGB, card=card)
    expect("a", launches, k1_fwd=2 * views)
    if _clean(rnd_launches) != dict(ZERO, k1_fwd=2 * views):
        raise RuntimeError(f"infer_cli (a): the random checkpoint launched {rnd_launches}")
    if not rep_a["mean"]["psnr"] > rep_rnd["mean"]["psnr"] + 1.0:
        raise RuntimeError(f"infer_cli (a): trained {rep_a['mean']} does not beat random "
                           f"{rep_rnd['mean']}")
    if rgb_err > FRAME_TOL_RGB or abs(view0_psnr - rep_a["views"][0]["psnr"]) > 1e-3:
        raise RuntimeError(f"infer_cli (a): view 0 {rgb_err} from the CPU path, PSNR "
                           f"{view0_psnr} against the report's {rep_a['views'][0]}")
    del cpu
    torch.cuda.empty_cache()

    # (b) int8: K4 alone, view 0 within the server's gate of (a)'s.
    rep_b, _, launches, seconds = evaluate("b", "--quant", "int8")
    psnr_b = frame_psnr(pred("a"), pred("b"))
    say("infer_cli_eval", part="b", launches=launches, seconds=seconds, mean=rep_b["mean"],
        view0_psnr_vs_float_db=psnr_b, gate_db=QUANT_GATE_DB, card=card)
    expect("b", launches, k4=2 * views)
    if not psnr_b >= QUANT_GATE_DB:
        raise RuntimeError(f"infer_cli (b): int8 view 0 at {psnr_b} dB of the float one")

    # (c) the distilled sampler at its defaults, saved to the cache; the same
    # call again loads it and gives the same report.
    rep_c, out_c, launches, seconds = evaluate("c", "--sampler", "proposal",
                                               "--infer-cache", cache)
    m = DISTILL_LINE.search(out_c)
    distill = None if m is None else {"steps": int(m[1]), "batch": int(m[2]),
                                      "seconds": float(m[3]), "first_loss": float(m[4]),
                                      "final_loss": float(m[5])}
    rep_c2, out_c2, launches2, _ = evaluate("c2", "--sampler", "proposal",
                                            "--infer-cache", cache)
    say("infer_cli_eval", part="c", launches=launches, seconds=seconds, distill=distill,
        mean=rep_c["mean"], float_mean=rep_a["mean"], saved=os.path.exists(cache),
        second_call_launches=launches2, card=card)
    expect("c", launches, k1_fwd=views)
    expect("c, second call", launches2, k1_fwd=views)
    if distill is None or (distill["steps"], distill["batch"]) != (1500, 16384) or not (
            math.isfinite(distill["final_loss"])
            and distill["final_loss"] < distill["first_loss"]):
        raise RuntimeError(f"infer_cli (c): distillation {distill}")
    if "saved inference artifacts" not in out_c or not os.path.exists(cache):
        raise RuntimeError("infer_cli (c): the cache was not saved")
    if f"loaded inference artifacts from {cache}" not in out_c2 or "distilled" in out_c2 \
            or rep_c2["views"] != rep_c["views"]:
        raise RuntimeError(f"infer_cli (c): the second call did not reuse the cache: "
                           f"{rep_c2['views']} against {rep_c['views']}")

    # Where the distillation's wall time goes: 100 steps, their device time
    # (torch.profiler) against the host clock.
    fine = gpu.eval_params["fine"]
    o_t, d_t = torch.tensor(o, device=gpu.device), torch.tensor(d, device=gpu.device)

    def distill_100():
        distill_proposal(lambda p: fine.sigma_logits(encode_position(p, cfg.l_xyz).to(
            fine.compute_dtype)), o_t, d_t, 2.0, 6.0, steps=100)

    wall_ms = _host_ms(distill_100, reps=3)
    dev_ms = device_ms_by_kernel(distill_100, {"gemm": ("gemm", "Gemm")})
    say("infer_cli_distill_profile", steps=100, batch=16384, wall_ms=wall_ms,
        device_ms=dev_ms["all"], gemm_device_ms=dev_ms["gemm"],
        idle_share=1.0 - dev_ms["all"] / wall_ms, card=card)

    # (d) int8 with the distilled sampler, on a copy of (c)'s cache.
    cache_d = os.path.join(tmp, "d.infer.npz")
    shutil.copyfile(cache, cache_d)
    rep_d, out_d, launches, seconds = evaluate("d", "--sampler", "proposal", "--quant",
                                               "int8", "--infer-cache", cache_d)
    say("infer_cli_eval", part="d", launches=launches, seconds=seconds, mean=rep_d["mean"],
        card=card)
    expect("d", launches, k4=views)
    if "distilled" in out_d:
        raise RuntimeError("infer_cli (d): distilled again instead of loading the cache")

    # (e) the inference CLI: loads the net, calibrates, saves both; the
    # gates decide the launches.
    video, depth_video = os.path.join(tmp, "e.mp4"), os.path.join(tmp, "e_depth.mp4")
    t0 = time.perf_counter()
    with _captured_frames() as handed:
        written, out_e, launches = _cli(infer_cli.run_inference, [
            "--config", CONFIG, "--checkpoint", run, "--frames", "8", "--quant", "int8",
            "--sampler", "proposal", "--infer-cache", cache, "--depth-video", "--out",
            video])
    seconds = time.perf_counter() - t0
    launches = _clean(launches)
    runs.append(launches)
    gates = {g[0]: {"decision": g[1], "psnr_db": float(g[2])}
             for g in GATE_LINE.findall(out_e)}
    q = gates.get("int8", {}).get("decision") == "PASS"
    s = gates.get("proposal", {}).get("decision") == "PASS"
    per_frame = 1 if s else 2
    want = dict(k1_fwd=2 + (0 if q else 3 + 8 * per_frame),
                k4=2 + (3 + 8 * per_frame if q else 0))
    frame_ms = [float(x) for x in FRAME_MS.findall(out_e)]
    # The port's GIFs (no mp4 encoder on the card's machine): 8 frames of
    # 30 ms each, looping; the depth frames as handed over and the rgb
    # frames as the writer's own palette mapping, bit for bit.
    depth = os.path.join(tmp, "e_depth.gif")
    if written != os.path.join(tmp, "e.gif") or not os.path.isfile(depth):
        raise RuntimeError(f"infer_cli (e): wrote {written}, depth {depth} "
                           f"{'present' if os.path.isfile(depth) else 'missing'}")
    files = {"e.gif": _video_back(written, handed[video], "infer_cli (e)"),
             "e_depth.gif": _video_back(depth, handed[depth_video], "infer_cli (e)")}
    rgb_back, depth_back = read_gif(written)[0], read_gif(depth)[0]
    if any(f["frames"] != 8 or f["durations_ms"] != [30] * 8 for f in files.values()) or \
            not all(np.array_equal(g, np.repeat(f[..., None], 3, axis=-1))
                    for g, f in zip(depth_back, handed[depth_video])):
        raise RuntimeError(f"infer_cli (e): the GIFs read back as {files}")
    rgb_psnr = [frame_psnr(f.astype(np.float32) / 255.0, g.astype(np.float32) / 255.0)
                for f, g in zip(handed[video], rgb_back)]
    write_s = handed.seconds[video] + handed.seconds[depth_video]
    trainer = Trainer(cfg, 2.0, 6.0, device="cuda").restore(ckpt)
    trainer.load_inference_artifacts(cache)
    pose = infer_cli.spherical_poses(8)[3]
    focal = 1.2 * max(cfg.height, cfg.width)
    paths = {}
    for quant_ in (False, True):
        for sampler in ("coarse", "proposal"):
            paths[f"{'int8' if quant_ else 'float'}/{sampler}"] = _host_ms(
                lambda: trainer.render_image(pose, cfg.height, cfg.width, focal,
                                             quant=quant_, sampler=sampler,
                                             uint8_rgb=True, need_depth=False))
    say("infer_cli_infer", part="e", launches=launches, expected=dict(ZERO, **want),
        gates=gates, seconds=seconds, frame_ms=frame_ms,
        median_frame_ms=statistics.median(frame_ms) if frame_ms else None,
        frame_ms_by_path=paths, written=os.path.basename(written), files=files,
        rgb_psnr_vs_frames_db=rgb_psnr, write_video_s=write_s, card=card)
    if len(gates) != 2 or launches != dict(ZERO, **want):
        raise RuntimeError(f"infer_cli (e): gates {gates}, launched {launches}, "
                           f"expected {want}")
    if "loaded inference artifacts" not in out_e or "distilled" in out_e \
            or "saved inference artifacts" not in out_e:
        raise RuntimeError("infer_cli (e): the net was not loaded, or the tables not saved")
    if not (trainer.quant_ready and trainer.proposal_ready):
        raise RuntimeError("infer_cli (e): the saved cache lacks the tables or the net")
    if len(frame_ms) != 8:
        raise RuntimeError(f"infer_cli (e): frames {frame_ms}")
    # The video file on the card's host: 30 frames of the orbit at 800x800
    # through the path the gates chose, encoded and read back.
    size = 800
    orbit = [trainer.render_image(p, size, size, 1.2 * size, quant=q,
                                  sampler="proposal" if s else "coarse",
                                  uint8_rgb=True, need_depth=False)["rgb"]
             for p in infer_cli.spherical_poses(30)]
    t0 = time.perf_counter()
    data = encode_gif(orbit, max(1, int(1000 / 30)))
    encode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back, durations, loop = decode_gif(data)
    decode_s = time.perf_counter() - t0
    mpx = 30 * size * size / 1e6
    psnr_min = min(frame_psnr(f.astype(np.float32) / 255.0, g.astype(np.float32) / 255.0)
                   for f, g in zip(orbit, back))
    # At full size (over 256 colours a frame: median cut, nearest entry,
    # LZW table resets) the frames read back must be the writer's own
    # palette mapping, bit for bit.
    want = shown_frames(orbit)
    exact = len(back) == len(want) and all(np.array_equal(g, w) for g, w in zip(back, want))
    say("video", frames=30, size=[size, size], encode_mpx_s=mpx / encode_s,
        decode_mpx_s=mpx / decode_s, encode_s=encode_s, decode_s=decode_s,
        bytes_per_frame=len(data) / 30, sha256=hashlib.sha256(data).hexdigest(),
        frames_back=len(back), mapping_exact=exact, psnr_db_min=psnr_min,
        e_write_video_s=write_s, e_seconds=seconds, e_write_share=write_s / seconds,
        card=card)
    if len(back) != 30 or durations != [30] * 30 or loop != 0 or not exact or \
            psnr_min < VIDEO_PSNR_FLOOR_DB:
        raise RuntimeError(f"video: {len(back)} frames of {durations} ms, loop {loop}, "
                           f"the writer's mapping {'exact' if exact else 'missed'}, "
                           f"worst frame {psnr_min:.2f} dB (floor {VIDEO_PSNR_FLOOR_DB})")
    del trainer, gpu
    torch.cuda.empty_cache()

    # (f) the server on the same cache: no distillation; then a cache of the
    # random weights is ignored with the notice and overwritten.
    tee = _Tee(sys.stdout)
    reset_counts()
    with contextlib.redirect_stdout(tee):
        service = RenderService(cfg, run, device="cuda", sampler="proposal",
                                infer_cache=cache)
    server = serve(service, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        base_url = f"http://127.0.0.1:{server.server_address[1]}"
        png, latency = _get(f"{base_url}/render?theta=10&phi=-30&radius=4")
        stats = json.loads(_get(f"{base_url}/stats")[0])
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    launches = counts()
    runs.append(launches)
    out_f = tee.buf.getvalue()
    frame = 1 if service.use_sampler == "proposal" else 2
    say("infer_cli_serve", part="f", launches=launches, sampler=stats["sampler"],
        gate_psnr_db=service.sampler_gate_psnr, latency_s=latency,
        shape=list(decode_png(png).shape), card=card)
    expect("f", launches, k1_fwd=2 + 1 + frame)
    if f"loaded inference artifacts from {cache}" not in out_f or "distilled" in out_f \
            or stats["sampler"] != service.use_sampler:
        raise RuntimeError(f"infer_cli (f): {stats}; {out_f}")
    stale = os.path.join(tmp, "stale.infer.npz")
    rnd = Trainer(cfg, 2.0, 6.0, device="cuda").restore(rnd_ckpt)
    rnd.quantize_for_inference(o, d)
    rnd.save_inference_artifacts(stale)
    before = np.load(stale)["__digest__"].item()
    tee = _Tee(sys.stdout)
    reset_counts()
    with contextlib.redirect_stdout(tee):
        service = RenderService(cfg, run, device="cuda", sampler="proposal",
                                proposal_steps=200, infer_cache=stale)
    launches = counts()
    runs.append(launches)
    out_f = tee.buf.getvalue()
    after = np.load(stale)["__digest__"].item()
    say("infer_cli_serve", part="f_stale", launches=launches, sampler=service.use_sampler,
        digest_before=before[:12], digest_after=after[:12], card=card)
    expect("f, stale cache", launches, k1_fwd=3)
    if "ignoring artifact cache" not in out_f or "saved inference artifacts" not in out_f \
            or after != service.trainer.infer_digest() or after == before:
        raise RuntimeError(f"infer_cli (f): the stale cache was not replaced: {out_f}")
    return runs


FERN_CONFIG = os.path.join(os.path.dirname(CONFIG), "fern_batch_h256_tpu.json")
# The synthetic capture: 20 views of 378x504 with the focal of a factor-8
# Fern view (3260 px at 4032 wide): 19 train views (3,619,728 rays, 883
# steps of 4096) and the holdout.
FERN_VIEWS, FERN_FOCAL = 20, 407.5
# (b) anneals the encoding over 1,300 steps: after its one epoch (883
# steps) the checkpoint is still inside the window (octaves 7-9 masked).
FERN_ANNEAL_STEPS = 1300


@contextlib.contextmanager
def _loss_probe(every: int):
    """Record ``(step, loss)`` of every ``every``-th train step (each read
    waits for the card)."""
    seen, real = [], Trainer.train_step

    def probed(self, batch, draws=None):
        metrics = real(self, batch, draws)
        if (self.step - 1) % every == 0:
            seen.append((self.step - 1, float(metrics["loss"])))
        return metrics

    Trainer.train_step = probed
    try:
        yield seen
    finally:
        Trainer.train_step = real


def _fern_train(phase: str, tag: str, config: str, cap: str, run: str, cfg,
                expected: dict, runs: list):
    """``cli.train_fern --epochs 1`` on capture ``cap`` in-process: the native
    batcher feeds it, exactly ``expected`` launches, the loss read every 100
    steps finite and falling, the checkpoint, its sidecar and the history
    written.  Appends the launches to ``runs``; returns (trainer, stdout,
    launches, epoch lines, loss probe, history)."""
    with _loss_probe(100) as probe:
        trainer, out, launches = _cli(train_fern.main, [
            "--config", config, "--data-dir", cap, "--run-dir", run, "--epochs", "1",
            "--eval-every", "1"])
    epochs = [{"epoch": int(m[0]), "krays_per_s": float(m[1]), "step_ms": float(m[2])}
              for m in EPOCH_LINE.findall(out)]
    name = checkpoint_name(cfg)
    files = {f: os.path.exists(os.path.join(run, f))
             for f in (name, name + ".config.json", _history_name(cfg))}
    if "batches: native batcher" not in out or "using numpy" in out:
        raise RuntimeError(f"{phase} ({tag}): the native batcher did not feed the run")
    if launches != expected:
        raise RuntimeError(f"{phase} ({tag}): launched {launches}, expected {expected}")
    if not all(files.values()) or len(epochs) != 1:
        raise RuntimeError(f"{phase} ({tag}): files {files}, epoch lines {epochs}")
    losses = [loss for _, loss in probe]
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise RuntimeError(f"{phase} ({tag}): the train loss did not fall: {probe}")
    runs.append(_clean(launches))
    history = History.load(os.path.join(run, _history_name(cfg)))
    return trainer, out, launches, epochs, probe, history


def _fern_spiral(phase: str, config: str, run: str, cap: str, frames: int, chunks: int,
                 tmp: str, runs: list) -> dict:
    """``cli.infer --path spiral`` on ``run``, float (K1 only: 2 a chunk) then
    ``--quant int8`` (the gate's float and int8 frames, then int8 frames
    only, 2 K4 a chunk; the gate must pass).  Appends the launches to
    ``runs``; returns each part's launches, gates and frame times."""
    parts = {}
    for tag, extra in (("float", []), ("int8", ["--quant", "int8"])):
        t0 = time.perf_counter()
        video = os.path.join(tmp, f"{phase}_{tag}.mp4")
        with _captured_frames() as handed:
            written, out, launches = _cli(infer_cli.run_inference, [
                "--config", config, "--checkpoint", run, "--path", "spiral", "--data-dir",
                cap, "--frames", str(frames), "--out", video] + extra)
        seconds = time.perf_counter() - t0
        back = _video_back(written, handed[video], f"{phase} ({tag})")
        launches = _clean(launches)
        runs.append(launches)
        gates = {g[0]: {"decision": g[1], "psnr_db": float(g[2])}
                 for g in GATE_LINE.findall(out)}
        frame_ms = [float(x) for x in FRAME_MS.findall(out)]
        per_frame = 2 * chunks
        if tag == "float":
            want = dict(ZERO, k1_fwd=frames * per_frame)
        else:
            want = dict(ZERO, k1_fwd=per_frame, k4=(frames + 1) * per_frame)
        parts[tag] = {"launches": launches, "expected": want, "gates": gates,
                      "seconds": seconds, "frame_ms": frame_ms, "video": back,
                      "s_per_frame": statistics.median(frame_ms) / 1e3 if frame_ms else None}
        if launches != want or len(frame_ms) != frames:
            raise RuntimeError(f"{phase} ({tag}): launched {launches}, expected {want}; "
                               f"frames {frame_ms}")
        if tag == "int8" and gates.get("int8", {}).get("decision") != "PASS":
            raise RuntimeError(f"{phase}: the int8 gate did not pass: {gates}")
    return parts


def phase_fern_cli(card: str, tmp: str) -> list[dict]:
    """Phase 21 (module docstring): the forward-facing path at the Fern
    config's widths on a synthetic LLFF capture, (a)-(e)."""
    cap = os.path.join(tmp, "fern_capture")
    t0 = time.perf_counter()
    write_forward_facing_capture(cap, FERN_VIEWS, 378, 504, FERN_FOCAL)
    write_s = time.perf_counter() - t0
    cfg = dataclasses.replace(load_config(FERN_CONFIG), epochs=1)

    def prepare(h, w):
        return train_fern.prepare(h, w, data_dir=cap)

    expected, steps = _expected_launches(cfg, prepare, 1, 1)
    runs = []

    # (a) world space, the config as shipped.
    run_a = os.path.join(tmp, "fern_run")
    trainer, out, launches, epochs, probe, history = _fern_train(
        "fern_cli", "a", FERN_CONFIG, cap, run_a, cfg, expected, runs)
    bounds = re.search(r"near=(\S+) far=(\S+) focal=(\S+)", out).groups()
    say("fern_cli_train", part="a", size=[cfg.height, cfg.width], views=FERN_VIEWS,
        capture_write_s=write_s, batch=cfg.batch_size, samples=[cfg.ns_coarse, cfg.ns_fine],
        mlp=[cfg.num_layers, cfg.hidden_dim], steps_per_epoch=steps, epochs=epochs,
        bounds=bounds, launches=launches, expected=expected, loss_probe=probe,
        val_psnr=history.val["psnrs"], card=card)
    del trainer
    torch.cuda.empty_cache()

    # (b) NDC with the frequency anneal still open at the checkpoint.
    ndc_config = _config_file(os.path.join(tmp, "fern_ndc.json"), base=FERN_CONFIG,
                              NDC=True, FREQ_ANNEAL_STEPS=FERN_ANNEAL_STEPS)
    ndc_cfg = dataclasses.replace(load_config(ndc_config), epochs=1)
    run_b = os.path.join(tmp, "fern_ndc_run")
    trainer, out, launches, epochs, probe, history = _fern_train(
        "fern_cli", "b", ndc_config, cap, run_b, cfg, expected, runs)
    ckpt = os.path.join(run_b, checkpoint_name(ndc_cfg))
    with open(ckpt + ".config.json") as f:
        scene = json.load(f)["SCENE"]
    # One step's gradients mid-window, kernel path against plain path, on
    # a batch of the NDC train rays.
    train_ds, _, _, _ = prepare(cfg.height, cfg.width)
    train_ds = dataset_to_ndc(train_ds)
    idx = np.random.default_rng(0).choice(len(train_ds), cfg.batch_size, replace=False)
    batch = trainer.put_batch((train_ds.pixels[idx], train_ds.origins[idx],
                               train_ds.directions[idx]))
    alpha = anneal_alpha(trainer.step, FERN_ANNEAL_STEPS)
    masked = torch.nonzero(freq_window(ndc_cfg.l_xyz, alpha) == 0).flatten().tolist()
    _, by_model, max_abs, kernel = _grads_kernel_vs_plain(
        ndc_cfg, trainer, batch, [(cfg.batch_size, cfg.ns_fine)], seed=5,
        autograd_fold=True)
    rel = max(max(v) for v in by_model.values())
    # A finiteness check: the window's 0 times a finite gradient is 0.
    trunk0 = {name: float(g[0][:, masked].abs().max()) for name, g in kernel.items()}
    say("fern_cli_train", part="b", ndc_printed="near=0.000 far=1.000" in out,
        scene=scene, step=trainer.step, anneal_alpha=alpha, masked_columns=len(masked),
        epochs=epochs, launches=launches, expected=expected, loss_probe=probe,
        val_psnr=history.val["psnrs"], grads_max_rel_l2=rel, grads_max_abs_err=max_abs,
        tol_rel=STEP_TOL_REL, masked_trunk0_grad_max=trunk0, card=card)
    if "near=0.000 far=1.000" not in out or scene.get("NDC") is not True:
        raise RuntimeError(f"fern_cli (b): NDC bounds not printed, or SCENE {scene}")
    if not 0 < alpha < 1 or not masked:
        raise RuntimeError(f"fern_cli (b): the window is not open at step {trainer.step}")
    if rel > STEP_TOL_REL or any(v != 0.0 for v in trunk0.values()):
        raise RuntimeError(f"fern_cli (b): kernel-path gradients {rel} (masked columns "
                           f"{trunk0}) against the plain path")
    del trainer, kernel, batch
    torch.cuda.empty_cache()

    # (c) the evaluation CLI on (b), against a random-weight checkpoint and
    # the CPU path.
    chunks = math.ceil(cfg.height * cfg.width / 16384)
    t0 = time.perf_counter()
    rep, _, launches = _cli(eval_cli.run_evaluation, [
        "--config", ndc_config, "--checkpoint", run_b, "--data", "llff", "--data-dir", cap,
        "--out", os.path.join(tmp, "fern_eval.json")])
    seconds = time.perf_counter() - t0
    runs.append(_clean(launches))
    rnd_dir = os.path.join(tmp, "fern_random")
    os.makedirs(rnd_dir)
    rnd_ckpt = os.path.join(rnd_dir, "random.ckpt.npz")
    save_params_npz(rnd_ckpt, random_params(ndc_cfg, seed=0), ndc_cfg,
                    scene={"near": 0.0, "far": 1.0, "focal": FERN_FOCAL, "ndc": True})
    rep_rnd, _, rnd_launches = _cli(eval_cli.run_evaluation, [
        "--config", ndc_config, "--checkpoint", rnd_ckpt, "--data", "llff", "--data-dir",
        cap, "--out", os.path.join(tmp, "fern_eval_random.json")])
    runs.append(_clean(rnd_launches))
    _, val_ds, _, _ = prepare(cfg.height, cfg.width)
    o, d = dataset_to_ndc(val_ds).image_rays(0)
    gpu = Trainer(ndc_cfg, 0.0, 1.0, device="cuda").restore(ckpt)
    full = gpu.render_rays(o, d, keys=("rgb_fine",))["rgb_fine"]
    view_ms = _host_ms(lambda: gpu.render_rays(o, d, keys=("rgb_fine",)), reps=3)
    idx = np.arange(0, o.shape[0], 40)
    cpu = Trainer(ndc_cfg, 0.0, 1.0, device="cpu").restore(ckpt)
    ref = cpu.render_rays(o[idx], d[idx], keys=("rgb_fine",))["rgb_fine"]
    rgb_err = float(np.abs(full[idx] - ref).max())
    say("fern_cli_eval", part="c", launches=_clean(launches), expected=dict(ZERO, k1_fwd=2 * chunks),
        seconds=seconds, view_ms=view_ms, mean=rep["mean"], random_mean=rep_rnd["mean"],
        view_rgb_max_vs_cpu=rgb_err, rays_checked=len(idx), tol_rgb=FRAME_TOL_RGB, card=card)
    if _clean(launches) != dict(ZERO, k1_fwd=2 * chunks) or \
            _clean(rnd_launches) != dict(ZERO, k1_fwd=2 * chunks):
        raise RuntimeError(f"fern_cli (c): launched {launches} / {rnd_launches}, expected "
                           f"{2 * chunks} K1 each")
    if not rep["mean"]["psnr"] > rep_rnd["mean"]["psnr"] + 1.0:
        raise RuntimeError(f"fern_cli (c): trained {rep['mean']} does not beat random "
                           f"{rep_rnd['mean']}")
    if rgb_err > FRAME_TOL_RGB:
        raise RuntimeError(f"fern_cli (c): the val view is {rgb_err} from the CPU path")
    del cpu, gpu
    torch.cuda.empty_cache()

    # (d) the spiral path of the capture, float then int8.
    frames = 5
    parts = _fern_spiral("fern_cli", ndc_config, run_b, cap, frames, chunks, tmp, runs)
    say("fern_cli_infer", part="d", size=[cfg.height, cfg.width], frames=frames, **parts,
        card=card)

    # (e) the orbit on (b)'s checkpoint: a level camera (half its rays point
    # up) must be refused before any launch.
    reset_counts()
    try:
        infer_cli.run_inference(["--config", ndc_config, "--checkpoint", run_b, "--frames",
                                 "1", "--phi", "0", "--out", os.path.join(tmp, "orbit.mp4")])
    except ValueError as e:
        if "forward-facing camera" not in str(e):
            raise
        refused = str(e)
    else:
        raise RuntimeError("fern_cli (e): the orbit rendered an NDC checkpoint")
    say("fern_cli_orbit_guard", part="e", error=refused, launches=counts(), card=card)
    if counts() != ZERO:
        raise RuntimeError(f"fern_cli (e): launched {counts()} before refusing")
    return runs


# The JPEG-only capture committed for phase fern_jpeg, written by PIL 12.1.0
# (tests/torch_jpeg_fixtures.py): 8 views of 504x672 in images/ only, and
# the SHA-256 of PIL's decode of every fixture file and of PIL's LANCZOS
# minify by 8 of every view.
JPEG_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                             "fixtures", "torch_jpeg")


def _digest(img: np.ndarray) -> dict:
    img = np.ascontiguousarray(img, dtype=np.uint8)
    return {"shape": list(img.shape), "sha256": hashlib.sha256(img.tobytes()).hexdigest()}


def phase_fern_jpeg(card: str, tmp: str) -> list[dict]:
    """Phase 25 (module docstring): a user's own capture shipped as
    full-size JPEGs, minified and decoded by the port, then trained, scored
    and rendered at the Fern config's widths, (a)-(d)."""
    with open(os.path.join(JPEG_FIXTURES, "goldens.json")) as f:
        goldens = json.load(f)
    cap = os.path.join(tmp, "jpeg_capture")
    shutil.copytree(os.path.join(JPEG_FIXTURES, "capture"), cap)
    if os.path.exists(os.path.join(cap, "images_8")):
        raise RuntimeError(f"fern_jpeg: {cap} already holds images_8/")

    # (a) the decoder and minify on this machine's host, against PIL's
    # digests (this machine has no PIL).
    t0 = time.perf_counter()
    jpeg_codec.load_library()
    build_s = time.perf_counter() - t0
    wrong = {}
    for rel, want in goldens["decode"].items():
        if _digest(llff._read_rgb_u8(os.path.join(JPEG_FIXTURES, rel))) != want:
            wrong[rel] = "decode"
    frames = sorted(os.listdir(os.path.join(cap, "images")))
    t0 = time.perf_counter()
    decoded = [llff._read_rgb_u8(os.path.join(cap, "images", f)) for f in frames]
    decode_s = time.perf_counter() - t0
    mpx = sum(im.shape[0] * im.shape[1] for im in decoded) / 1e6
    t0 = time.perf_counter()
    out_dir = llff.minify(cap, 8)
    minify_s = time.perf_counter() - t0
    for f in frames:
        with open(os.path.join(out_dir, os.path.splitext(f)[0] + ".png"), "rb") as fh:
            small = decode_png(fh.read())
        if _digest(small) != goldens["minify"][f"capture/images/{f}"]:
            wrong[f"capture/images/{f}"] = "minify"
    say("fern_jpeg", part="a", frames=len(frames), frame_size=list(decoded[0].shape),
        decode_files_checked=len(goldens["decode"]), minify_files_checked=len(frames),
        mismatches=wrong, build_s=build_s, decode_s=decode_s, decode_mpx=mpx,
        decode_mpx_per_s=mpx / decode_s, minify_s=minify_s, card=card)
    if wrong or len(frames) != len(goldens["minify"]):
        raise RuntimeError(f"fern_jpeg (a): the port differs from PIL's digests: {wrong}")

    # (b) the training CLI on the minified capture, the config as shipped.
    cfg = dataclasses.replace(load_config(FERN_CONFIG), epochs=1)

    def prepare(h, w):
        return train_fern.prepare(h, w, data_dir=cap)

    expected, steps = _expected_launches(cfg, prepare, 1, 1)
    runs = []
    run = os.path.join(tmp, "jpeg_run")
    trainer, out, launches, epochs, probe, history = _fern_train(
        "fern_jpeg", "b", FERN_CONFIG, cap, run, cfg, expected, runs)
    near, far, focal = (float(v) for v in
                        re.search(r"near=(\S+) far=(\S+) focal=(\S+)", out).groups())
    say("fern_jpeg", part="b", size=[cfg.height, cfg.width], batch=cfg.batch_size,
        samples=[cfg.ns_coarse, cfg.ns_fine], mlp=[cfg.num_layers, cfg.hidden_dim],
        steps_per_epoch=steps, epochs=epochs, bounds=[near, far, focal], launches=launches,
        expected=expected, loss_probe=probe, val_psnr=history.val["psnrs"], card=card)
    del trainer
    torch.cuda.empty_cache()

    # (c) the evaluation CLI on (b)'s checkpoint against random weights.
    chunks = math.ceil(cfg.height * cfg.width / 16384)
    want = dict(ZERO, k1_fwd=2 * chunks)
    reports = {}
    rnd_ckpt = os.path.join(tmp, "jpeg_random", "random.ckpt.npz")
    os.makedirs(os.path.dirname(rnd_ckpt))
    save_params_npz(rnd_ckpt, random_params(cfg, seed=0), cfg,
                    scene={"near": near, "far": far, "focal": focal, "ndc": False})
    for tag, ckpt in (("trained", run), ("random", rnd_ckpt)):
        t0 = time.perf_counter()
        rep, _, launches = _cli(eval_cli.run_evaluation, [
            "--config", FERN_CONFIG, "--checkpoint", ckpt, "--data", "llff", "--data-dir",
            cap, "--out", os.path.join(tmp, f"jpeg_eval_{tag}.json")])
        runs.append(_clean(launches))
        reports[tag] = {"mean": rep["mean"], "launches": _clean(launches),
                        "seconds": time.perf_counter() - t0}
        if _clean(launches) != want:
            raise RuntimeError(f"fern_jpeg (c, {tag}): launched {launches}, expected {want}")
    say("fern_jpeg", part="c", expected=want, **reports, card=card)
    if not reports["trained"]["mean"]["psnr"] > reports["random"]["mean"]["psnr"] + 1.0:
        raise RuntimeError(f"fern_jpeg (c): trained {reports['trained']} does not beat "
                           f"random {reports['random']} by 1 dB")

    # (d) the capture's spiral path, float then int8.
    frames_n = 2
    parts = _fern_spiral("fern_jpeg", FERN_CONFIG, run, cap, frames_n, chunks, tmp, runs)
    say("fern_jpeg", part="d", size=[cfg.height, cfg.width], frames=frames_n, **parts,
        card=card)
    return runs


# The fixtures of phase captures: a Blender scene of 16-bit, Adam7 and
# palette + tRNS PNG frames with the SHA-256 of PIL 12.1.0's
# convert("RGBA") of each (tests/torch_png_fixtures.py), and the
# progressive JPEGs of JPEG_FIXTURES.
PNG_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                            "fixtures", "torch_png")


def _paeth_png(samples: np.ndarray, depth: int) -> bytes:
    """An RGBA PNG (8 or 16 bits) of ``samples`` whose every row is
    Paeth-filtered: each row's predictor comes from the raw bytes, so numpy
    filters every row at once."""
    h, w, c = samples.shape
    raw = (samples.astype(">u2").view(np.uint8) if depth == 16
           else samples.astype(np.uint8)).reshape(h, -1).astype(np.int16)
    bpp = c * depth // 8
    a, b, up_left = (np.zeros_like(raw) for _ in range(3))
    a[:, bpp:], b[1:], up_left[1:, bpp:] = raw[:, :-bpp], raw[:-1], raw[:-1, :-bpp]
    p = a + b - up_left
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - up_left)
    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, up_left))
    rows = np.concatenate([np.full((h, 1), 4, np.uint8), ((raw - pred) & 0xFF).astype(np.uint8)],
                          axis=1)
    chunk = png_codec._chunk
    return b"".join([png_codec.PNG_SIGNATURE,
                     chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, 6, 0, 0, 0)),
                     chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)), chunk(b"IEND", b"")])


def _paeth_frame() -> np.ndarray:
    """The decode-rate frame: 800x800 16-bit RGBA, smooth ramps with noise
    in the low 10 bits (as a 16-bit render's low bits are)."""
    y, x = np.mgrid[0:800, 0:800]
    smooth = np.stack([x * 81, y * 79, (x + y) * 41, 65535 - x * 40], -1) % 65536
    noisy = smooth + np.random.default_rng(0).integers(0, 1024, smooth.shape)
    return np.minimum(noisy, 65535).astype(np.uint16)


def phase_captures(card: str, tmp: str) -> list[dict]:
    """Phase 28 (module docstring): a user's own capture in the PNG and
    JPEG layouts PIL reads, decoded on the card's host and trained through
    the kernels, (a)-(c)."""
    with open(os.path.join(PNG_FIXTURES, "goldens.json")) as f:
        png_goldens = json.load(f)["decode"]
    with open(os.path.join(JPEG_FIXTURES, "goldens.json")) as f:
        jpeg_goldens = json.load(f)
    scene = os.path.join(tmp, "png_scene")
    shutil.copytree(os.path.join(PNG_FIXTURES, "scene"), scene)
    cap = os.path.join(tmp, "progressive_capture")
    shutil.copytree(os.path.join(JPEG_FIXTURES, "capture_progressive"), cap)

    # (a) every new golden against the port's decoders, and decode rates.
    t0 = time.perf_counter()
    png_codec.load_library()
    build_s = time.perf_counter() - t0
    wrong = {}
    for rel, want in png_goldens.items():
        with open(os.path.join(scene, rel), "rb") as fh:
            data = fh.read()
        if _digest(to_rgba(decode_png(data), png_transparency(data))) != want:
            wrong[f"torch_png/scene/{rel}"] = "decode"
    progressive = {rel: want for rel, want in jpeg_goldens["decode"].items()
                   if rel.startswith(("cases/prog_", "capture_progressive/"))}
    for rel, want in progressive.items():
        if _digest(llff._read_rgb_u8(os.path.join(JPEG_FIXTURES, rel))) != want:
            wrong[f"torch_jpeg/{rel}"] = "decode"
    rgba16 = _paeth_frame()
    rgba8 = (rgba16 >> 8).astype(np.uint8)
    png8, png16 = _paeth_png(rgba8, 8), _paeth_png(rgba16, 16)
    exact = {"rgba8_paeth": bool(np.array_equal(decode_png(png8), rgba8)),
             "rgba16_paeth": bool(np.array_equal(decode_png(png16), rgba8))}
    view = os.path.join(cap, "images", sorted(os.listdir(os.path.join(cap, "images")))[0])
    with open(view, "rb") as fh:
        view_bytes = fh.read()
    shape = jpeg_codec.decode_jpeg(view_bytes, view).shape
    rates = {}  # Mpx/s of the median of 5 decodes after one
    for name, decode, mpx in (
            ("png_rgba8_800x800_paeth", lambda: decode_png(png8), 0.64),
            ("png_rgba16_800x800_paeth", lambda: decode_png(png16), 0.64),
            ("jpeg_progressive_504x672", lambda: jpeg_codec.decode_jpeg(view_bytes, view),
             shape[0] * shape[1] / 1e6)):
        rates[name] = mpx / (_host_ms(decode) / 1e3)
    say("captures", part="a", png_files_checked=len(png_goldens),
        jpeg_files_checked=len(progressive), mismatches=wrong, exact=exact,
        png_build_s=build_s, decode_mpx_per_s=rates,
        png_bytes={"rgba8": len(png8), "rgba16": len(png16)},
        card=card)
    if wrong or not all(exact.values()) or not progressive or shape != (504, 672, 3):
        raise RuntimeError(f"captures (a): the port differs from PIL's digests: {wrong}, "
                           f"exact {exact}, shape {shape}")
    runs = []

    # (b) the Blender scene through cli.train_blender at full width, then
    # cli.evaluate --data blender against random weights.
    bl_config = _config_file(os.path.join(tmp, "png_scene.json"), BATCH_SIZE=1024,
                             HEIGHT=40, WIDTH=40, WITH_GCS=False, WHITE_BKGD=True)
    bl_cfg = dataclasses.replace(load_config(bl_config), epochs=5)
    expected, bl_steps = _expected_launches(
        bl_cfg, lambda h, w: train_blender.prepare(h, w, data_dir=scene, config=bl_cfg), 5, 1)
    bl_run = os.path.join(tmp, "png_scene_run")
    t0 = time.perf_counter()
    trainer, out, launches = _cli(train_blender.main, [
        "--config", bl_config, "--data-dir", scene, "--run-dir", bl_run, "--epochs", "5",
        "--eval-every", "5"])
    train_s = time.perf_counter() - t0
    hist = History.load(os.path.join(bl_run, _history_name(bl_cfg)))
    if "batches: native batcher" not in out or launches != expected:
        raise RuntimeError(f"captures (b): launched {launches}, expected {expected}")
    if not (np.isfinite(hist.losses).all() and hist.losses[-1] < hist.losses[0]):
        raise RuntimeError(f"captures (b): the loss did not fall: {hist.losses}")
    runs.append(_clean(launches))
    del trainer
    rnd_ckpt = os.path.join(tmp, "png_scene_random", "random.ckpt.npz")
    os.makedirs(os.path.dirname(rnd_ckpt))
    _, _, (near, far), focal = train_blender.prepare(40, 40, data_dir=scene, config=bl_cfg)
    save_params_npz(rnd_ckpt, random_params(bl_cfg, seed=0), bl_cfg,
                    scene={"near": near, "far": far, "focal": focal, "ndc": False})
    reports, want = {}, dict(ZERO, k1_fwd=2)
    for tag, ckpt in (("trained", bl_run), ("random", rnd_ckpt)):
        rep, _, launches = _cli(eval_cli.run_evaluation, [
            "--config", bl_config, "--checkpoint", ckpt, "--data", "blender", "--data-dir",
            scene, "--out", os.path.join(tmp, f"png_scene_eval_{tag}.json")])
        runs.append(_clean(launches))
        reports[tag] = {"mean": rep["mean"], "views": len(rep["views"]),
                        "launches": _clean(launches)}
        if _clean(launches) != want or len(rep["views"]) != 1:
            raise RuntimeError(f"captures (b, {tag}): launched {launches}, expected {want}")
    say("captures", part="b", frames="6 train + 2 val 40x40: 16-bit RGBA (one Adam7), "
        "palette + tRNS (8-bit; 4-bit Adam7), 16-bit gray+alpha, 8-bit RGBA Adam7",
        steps=bl_steps * 5, launches=runs[0], expected=expected, train_s=train_s,
        losses=hist.losses, val_psnrs=hist.val["psnrs"], eval=reports, card=card)
    if not reports["trained"]["mean"]["psnr"] > reports["random"]["mean"]["psnr"] + 1.0:
        raise RuntimeError(f"captures (b): trained {reports['trained']} does not beat "
                           f"random {reports['random']} by 1 dB")
    torch.cuda.empty_cache()

    # (c) the progressive capture: minify, cli.train_fern, a spiral frame.
    t0 = time.perf_counter()
    out_dir = llff.minify(cap, 8)
    minify_s = time.perf_counter() - t0
    for rel, want in jpeg_goldens["minify_progressive"].items():
        stem = os.path.splitext(os.path.basename(rel))[0]
        with open(os.path.join(out_dir, stem + ".png"), "rb") as fh:
            if _digest(decode_png(fh.read())) != want:
                wrong[rel] = "minify"
    if wrong:
        raise RuntimeError(f"captures (c): minify differs from PIL's digests: {wrong}")
    cfg = dataclasses.replace(load_config(FERN_CONFIG), epochs=1)

    def prepare(h, w):
        return train_fern.prepare(h, w, data_dir=cap)

    expected, steps = _expected_launches(cfg, prepare, 1, 1)
    run = os.path.join(tmp, "progressive_run")
    t0 = time.perf_counter()
    trainer, out, launches, epochs, probe, history = _fern_train(
        "captures", "c", FERN_CONFIG, cap, run, cfg, expected, runs)
    train_s = time.perf_counter() - t0
    del trainer
    torch.cuda.empty_cache()
    chunks = math.ceil(cfg.height * cfg.width / 16384)
    want = dict(ZERO, k1_fwd=2 * chunks)
    video = os.path.join(tmp, "progressive_spiral.mp4")
    with _captured_frames() as handed:
        written, out, launches = _cli(infer_cli.run_inference, [
            "--config", FERN_CONFIG, "--checkpoint", run, "--path", "spiral", "--data-dir",
            cap, "--frames", "1", "--out", video])
    back = _video_back(written, handed[video], "captures (c)")
    frame_ms = [float(v) for v in FRAME_MS.findall(out)]
    runs.append(_clean(launches))
    say("captures", part="c", views=len(jpeg_goldens["minify_progressive"]),
        minify_s=minify_s, minify_checked=len(jpeg_goldens["minify_progressive"]),
        size=[cfg.height, cfg.width], steps_per_epoch=steps, epochs=epochs,
        train_launches=runs[-2], expected=expected, loss_probe=probe, train_s=train_s,
        val_psnr=history.val["psnrs"], spiral_launches=_clean(launches),
        spiral_expected=want, frame_ms=frame_ms, video=back, card=card)
    if _clean(launches) != want or len(frame_ms) != 1:
        raise RuntimeError(f"captures (c): the spiral launched {launches}, expected {want}; "
                           f"frames {frame_ms}")
    return runs


# Phase dp's gradient gate is K2's (relative L2 per leaf).  Two ranks are
# not one process up to summation order alone: each rank's weight gradient
# is rounded to bf16 before the sum (the cotangent of w.astype(bf16) is
# bf16, in the JAX package as in the plain path), so the weight leaves
# differ by ~bf16 epsilon: 2.5e-3 on an H100, 2.6e-3 in the plain path on
# the CPU at 4x64; the biases by ~1e-7.
DP_STEPS = 3
# The children of phase dp start, build nothing (the kernels are built) and
# take 3 + 10 steps; 300 s is a generous bound for one of them.
DP_TIMEOUT = 300.0


def _dp_launches(rec: dict, per_step: dict, render: dict | None = None) -> dict:
    """A rank's main-path launches (its steps and render), each step held
    to ``per_step`` exactly."""
    for i, grew in enumerate(rec["launches"]):
        if grew != per_step:
            raise RuntimeError(f"dp rank {rec['rank']}: step {i} launched {grew}, "
                               f"expected {per_step}")
    if render is not None and rec["render_launches"] != render:
        raise RuntimeError(f"dp rank {rec['rank']}: the render launched "
                           f"{rec['render_launches']}, expected {render}")
    total = dict(ZERO)
    for grew in rec["launches"] + ([rec["render_launches"]] if render else []):
        for k, v in grew.items():
            total[k] += v
    return total


def phase_dp(card: str) -> list[dict]:
    """Data parallelism: (a) a world of 1 on NCCL, (b) two gloo ranks on one
    card, each against one process without a mesh (module docstring, 22)."""
    cfg = parity_config()
    params = random_params(cfg, seed=7)
    batch = bench_batch(cfg.batch_size, seed=5)
    spec = {"near": 2.0, "far": 6.0, "batch": batch, "params": params, "steps": DP_STEPS}
    per_step = {"k1_train": 2, "k2": 2}

    # The reference: one process, no mesh, the whole batch; its generator
    # is seeded as every rank's, so the draws are the same.
    one = Trainer(cfg, 2.0, 6.0, device="cuda").replace_params(params)
    one.train_step(batch)
    want = one.params_tree(grad=True)
    del one
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    (rec,) = run_ranks(1, dict(spec, device="cuda", backend=None, cfg=cfg, time_steps=10,
                               profile=DP_STEPS), timeout=DP_TIMEOUT)
    a_s = time.perf_counter() - t0
    launches = [_dp_launches(rec, per_step)]
    got = _flatten(rec["grads"], "")
    diff = max(float(np.abs(got[k] - w).max()) for k, w in _flatten(want, "").items())
    nccl = rec["nccl_all_reduce"]
    say("dp_world1_nccl", backend=rec["backend"], device=rec["device"], steps=DP_STEPS,
        launches_per_step=rec["launches"], collectives=rec["audit"]["collectives"],
        nccl_all_reduce=nccl, grads_max_abs_diff_vs_no_mesh=diff,
        step_ms=rec["step_ms"], no_mesh_step_ms=rec["no_mesh_step_ms"], wall_s=a_s,
        card=card)
    if rec["backend"] != "nccl":
        raise RuntimeError(f"world 1 ran on {rec['backend']}, not NCCL")
    if nccl["host_calls"] != DP_STEPS or not nccl["device_events"]:
        raise RuntimeError(f"the profiler saw {nccl} over {DP_STEPS} steps: expected one "
                           f"NCCL all-reduce a step among the device work")
    if diff != 0.0:
        raise RuntimeError(f"world-1 gradients differ from the no-mesh step by {diff}")

    t0 = time.perf_counter()
    ranks = run_two_process_smoke("cuda", "gloo", dataclasses.asdict(cfg), DP_TIMEOUT,
                                  **dict(spec, render_rays=cfg.batch_size, time_steps=10))
    b_s = time.perf_counter() - t0
    launches += [_dp_launches(r, per_step, {"k1_fwd": 2}) for r in ranks]
    rel = tree_rel_l2(ranks[0]["grads"], want)
    broken = run_two_process_smoke("cuda", "gloo", dataclasses.asdict(cfg), DP_TIMEOUT,
                                   **dict(spec, steps=1, drop_rank=1))
    rel_broken = tree_rel_l2(broken[0]["grads"], want)
    say("dp_two_gloo_ranks_one_card", backend=ranks[0]["backend"],
        devices=[r["device"] for r in ranks], rays_per_rank=cfg.batch_size // 2,
        note="gloo asked for explicitly: NCCL refuses two ranks on one device; the two "
             "processes share one card, so the step ms is not a scaling figure",
        launches_per_step=ranks[0]["launches"], render_launches=ranks[0]["render_launches"],
        collectives=ranks[0]["audit"]["collectives"],
        render_collectives=ranks[0]["render_collectives"], digests_equal=True,
        grads_max_rel_l2_vs_one_process=rel, tol_rel=K2_TOL_REL,
        broken_rank1_left_out_rel_l2=rel_broken, step_ms=[r["step_ms"] for r in ranks],
        wall_s=b_s, card=card)
    if rel > K2_TOL_REL:
        raise RuntimeError(f"two-rank gradients disagree with one process: {rel}")
    if rel_broken < 10 * K2_TOL_REL:
        raise RuntimeError(f"the gate cannot see a rank left out of the reduce: "
                           f"{rel_broken} < 10 x {K2_TOL_REL}")
    return launches


# ---------------------------------------------------------------------------
# Phase 22b: scoring, rendering and serving on every rank of a data mesh.

# The distillation of phase dp_infer, cut from the default 1,500 steps of
# 16,384 points to 200 (the net need not be good: each rank must hold the
# same one as one process).
DPI_DISTILL = {"steps": 200}
DPI_SIZE = 200
# Two ranks against one process: each ray is rendered alone, so the maps
# agree bit for bit (expected 0); the gate allows float32 noise.
DPI_TOL = 1e-6
# Phase dp_infer (e): a server in each served mode (its flags and
# RenderService's, and its requests), each as two ranks and as one process.
DPI_RENDER = ("GET", f"/render?theta=30&width={DPI_SIZE}&height={DPI_SIZE}")
DPI_SERVERS = {
    "float": ([], {}, [DPI_RENDER, ("GET", "/stats")]),
    "int8": (["--quant", "int8"], {"quant": True},
             [DPI_RENDER, ("POST", "/reload"), ("GET", "/stats")]),
    "proposal": (["--sampler", "proposal", "--proposal-steps", str(DPI_DISTILL["steps"])],
                 {"sampler": "proposal", "proposal_steps": DPI_DISTILL["steps"]},
                 [DPI_RENDER, ("GET", "/stats")]),
}
# Each server's served setting and its gate lines (int8: at start and at
# /reload; proposal: at start).
DPI_SERVED = {"float": ("none", "coarse", 0), "int8": ("int8", "coarse", 2),
              "proposal": ("none", "proposal", 1)}
DPI_GATE_LINE = re.compile(r"\] (serving [a-z0-9 ]+?) gate (PASS|FAIL): (\S+) dB")
DPI_RENDERS = {"float": {}, "int8": {"quant": True}, "proposal": {"sampler": "proposal"},
               "proposal_int8": {"sampler": "proposal", "quant": True}}


def _dpi_launches(rec: dict, want: dict) -> dict:
    """A rank's render launches, each render held to ``want`` exactly;
    their sum."""
    total = dict(ZERO)
    for name in DPI_RENDERS:
        grew = dict(ZERO, **rec["steps"][name]["launches"])
        if grew != dict(ZERO, **want[name]):
            raise RuntimeError(f"dp_infer: the {name} render launched {grew}, expected "
                               f"{want[name]}")
        for k, v in grew.items():
            total[k] += v
    return total


def _dpi_max_diff(got: dict, want: dict) -> float:
    return max(float(np.abs(got[name][k] - want[name][k]).max())
               for name in want for k in want[name])


def phase_dp_infer(card: str, tmp: str) -> list[dict]:
    """Phase 22b (module docstring): the int8 tables, the distilled net and
    the cache under a mesh, and cli.evaluate and the server as two ranks."""
    cfg = load_config(CONFIG)
    params = random_params(cfg, seed=17)
    for tree in params.values():  # a denser field than sigma at 0
        tree["sigma"]["b"] = tree["sigma"]["b"] + 1.0
    cpu = Trainer(cfg, 2.0, 6.0, device="cpu")
    calib = [np.concatenate(x) for x in zip(*(
        [t.numpy() for t in cpu.pose_rays(pose_spherical(theta, -30.0, 4.0), 100, 100, 120.0)]
        for theta in (0.0, 90.0, 180.0, 270.0)))]
    rays = [t.numpy() for t in cpu.pose_rays(pose_spherical(30.0, -30.0, 4.0), DPI_SIZE,
                                             DPI_SIZE, 1.2 * DPI_SIZE)]
    del cpu
    chunks = -(-DPI_SIZE * DPI_SIZE // 16384)
    want_launches = {"float": {"k1_fwd": 2 * chunks}, "int8": {"k4": 2 * chunks},
                     "proposal": {"k1_fwd": chunks}, "proposal_int8": {"k4": chunks}}

    # The reference: one process, no mesh.
    one = Trainer(cfg, 2.0, 6.0, device="cuda").replace_params(params)
    one.quantize_for_inference(*calib)
    one.build_proposal_sampler(*calib, **DPI_DISTILL)
    ref_digests = artifact_digests(one)
    ref = {name: one.render_rays(*rays, **kw) for name, kw in DPI_RENDERS.items()}
    q_elems = sum(a.size for a in _flatten(quant.qparams_to_jax(one.qparams), "").values())
    p_elems = sum(p.numel() for p in one.proposal_net.parameters())
    del one
    torch.cuda.empty_cache()
    spec = {"cfg": cfg, "near": 2.0, "far": 6.0, "params": params,
            "infer": {"calib": calib, "distill": DPI_DISTILL, "rays": rays}}
    want_coll = {"calibrate": (1, 2, q_elems), "distill": (1, 1, p_elems),
                 "load": (1, 2, q_elems + p_elems)}

    def check_collectives(rec: dict, what: str) -> dict:
        got = {k: v["collectives"] for k, v in rec["steps"].items()}
        for step, (objects, broadcasts, elements) in want_coll.items():
            c = got[step]
            if (c["broadcast_object"], c["broadcast"], c["broadcast_elements"],
                    c["all_reduce"], c["all_gather"]) != (objects, broadcasts, elements, 0, 0):
                raise RuntimeError(f"dp_infer ({what}): {step} made {c}, expected "
                                   f"{objects} header and {broadcasts} broadcasts of "
                                   f"{elements} elements")
        for name, kw in DPI_RENDERS.items():
            c, maps = got[name], 2 if kw.get("sampler") else 4
            if (c["all_gather"], c["all_reduce"], c["broadcast"], c["broadcast_object"]) != (
                    chunks * maps, 0, 0, 0):
                raise RuntimeError(f"dp_infer ({what}): the {name} render made {c}")
        return {k: {kk: v for kk, v in c.items() if v} for k, c in got.items()}

    # (a) a world of 1 on NCCL.
    t0 = time.perf_counter()
    (rec,) = run_ranks(1, dict(spec, device="cuda", backend=None, infer=dict(
        spec["infer"], cache=os.path.join(tmp, "dpi_a.infer.npz"))), timeout=DP_TIMEOUT)
    a_s = time.perf_counter() - t0
    a = rec["infer"]
    launches = [_dpi_launches(a, want_launches)]
    diff = _dpi_max_diff(a["frames"], ref)
    coll = check_collectives(a, "a")
    say("dp_infer", part="a", backend=rec["backend"], device=rec["device"],
        digests_equal_no_mesh=a["digests"] == a["loaded_digests"] == ref_digests,
        frames_max_abs_diff_vs_no_mesh=diff, size=DPI_SIZE, chunks=chunks,
        launches={k: a["steps"][k]["launches"] for k in DPI_RENDERS}, collectives=coll,
        distill_steps=len(a["distill_losses"]), wall_s=a_s, card=card)
    if rec["backend"] != "nccl":
        raise RuntimeError(f"dp_infer (a): world 1 ran on {rec['backend']}, not NCCL")
    if not a["digests"] == a["loaded_digests"] == ref_digests or diff != 0.0:
        raise RuntimeError(f"dp_infer (a): world 1 differs from no mesh: digests "
                           f"{a['digests']} / {a['loaded_digests']} vs {ref_digests}, "
                           f"frames {diff}")

    # (b) two gloo ranks sharing the card.
    t0 = time.perf_counter()
    recs = run_ranks(2, dict(spec, device="cuda", backend="gloo", infer=dict(
        spec["infer"], cache=os.path.join(tmp, "dpi_b.infer.npz"), hidden_from=1)),
        timeout=DP_TIMEOUT)
    b_s = time.perf_counter() - t0
    b = [r["infer"] for r in recs]
    launches += [_dpi_launches(r, want_launches) for r in b]
    diffs = [_dpi_max_diff(r["frames"], ref) for r in b]
    coll = [check_collectives(r, "b") for r in b]
    same = all(r["digests"] == r["loaded_digests"] == ref_digests for r in b)
    say("dp_infer", part="b", backend=recs[0]["backend"],
        devices=[r["device"] for r in recs],
        note="gloo asked for explicitly: NCCL refuses two ranks on one device; rank 1 "
             "is given a path where no cache file is",
        digests_equal_one_process=same, frames_max_abs_diff_vs_one_process=diffs,
        tol=DPI_TOL, collectives=coll[0], collectives_equal=coll[0] == coll[1],
        wall_s=b_s, card=card)
    if not same or max(diffs) > DPI_TOL or coll[0] != coll[1]:
        raise RuntimeError(f"dp_infer (b): digests equal {same}, frames {diffs}, "
                           f"collectives {coll}")

    # (c) the broken variant: no rank shares, rank 1 calibrates on other rays.
    broken_calib = [t.numpy() for t in Trainer(cfg, 2.0, 6.0, device="cpu").pose_rays(
        pose_spherical(45.0, -60.0, 4.0), 100, 100, 120.0)]
    recs = run_ranks(2, dict(spec, device="cuda", backend="gloo", infer={
        "calib": calib, "rays": rays, "broken": True, "broken_calib": broken_calib}),
        timeout=DP_TIMEOUT)
    rgb = recs[0]["infer"]["frames"]["int8"]["rgb_fine"]
    want = ref["int8"]["rgb_fine"]
    rank1 = np.zeros(len(want), bool)
    for start in range(0, len(want), 16384):
        rank1[start + 8192:start + 16384] = True
    miss = float(np.abs(rgb[rank1] - want[rank1]).max())
    own = float(np.abs(rgb[~rank1] - want[~rank1]).max())
    say("dp_infer", part="c", rank0_rows_max_abs_diff=own, rank1_rows_max_abs_diff=miss,
        tol=DPI_TOL, card=card)
    if own > DPI_TOL or miss < 10 * DPI_TOL:
        raise RuntimeError(f"dp_infer (c): the gate cannot see unshared tables: rank 1's "
                           f"rows {miss}, rank 0's {own}")

    # (d) cli.evaluate and (e) a server in each served mode, two gloo
    # ranks, outputs under r{rank}/, against one process of each in this
    # process.
    ckpt = os.path.join(tmp, "dpi.ckpt.npz")
    save_params_npz(ckpt, params, cfg, scene={"near": 2.0, "far": 6.0, "focal": 120.0})
    for out in ("dpi_r0", "dpi_r1", "dpi_one"):
        os.makedirs(os.path.join(tmp, out))
    common = ["--config", CONFIG, "--checkpoint", ckpt]

    def ev_argv(out):
        return common + ["--quant", "int8", "--sampler", "proposal", "--proposal-steps",
                         str(DPI_DISTILL["steps"]), "--data", "synthetic", "--split", "val",
                         "--infer-cache", os.path.join(tmp, out, "c.infer.npz"), "--out",
                         os.path.join(tmp, out, "eval.json")]

    t0 = time.perf_counter()
    recs = run_ranks(2, {"cfg": cfg, "near": 2.0, "far": 6.0, "device": "cuda",
                         "backend": "gloo", "cli": [("evaluate", ev_argv("dpi_r{rank}"))] + [
        ("serve", common + flags + ["--port", str(free_port())], requests)
        for flags, _, requests in DPI_SERVERS.values()]}, timeout=DP_TIMEOUT)
    de_s = time.perf_counter() - t0
    clis = [r["cli"] for r in recs]
    report, _, one_launches = _cli(eval_cli.run_evaluation, ev_argv("dpi_one"))
    views = 3
    ev_launches = [dict(ZERO, **c[0]["launches"]) for c in clis]
    r1_files = os.listdir(os.path.join(tmp, "dpi_r1"))
    say("dp_infer", part="d", entry="cli.evaluate --quant int8 --sampler proposal "
        "--infer-cache", report_equal_one_process=clis[0][0]["result"] == report,
        mean=clis[0][0]["result"]["mean"], one_process_mean=report["mean"],
        launches=ev_launches, rank1_files=r1_files,
        rank0_files=sorted(os.listdir(os.path.join(tmp, "dpi_r0"))), card=card)
    if clis[0][0]["result"] != report or clis[1][0]["result"] != report:
        raise RuntimeError(f"dp_infer (d): the ranks' reports {clis[0][0]['result']} "
                           f"differ from one process's {report}")
    if any(x != dict(ZERO, k4=views) for x in ev_launches) or r1_files:
        raise RuntimeError(f"dp_infer (d): launches {ev_launches}, rank 1 wrote {r1_files}")
    launches += ev_launches

    # Each rank renders its rows of every chunk, so it launches per chunk
    # what one process launches, gates included: the launches of each
    # server equal one process's exactly.
    for i, (mode, (_, kw, requests)) in enumerate(DPI_SERVERS.items(), start=1):
        before = counts()
        service = RenderService(cfg, ckpt, device="cuda", **kw)
        server = serve(service, port=0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        bodies = []
        try:
            base = f"http://127.0.0.1:{server.server_address[1]}"
            for method, path in requests:
                req = urllib.request.Request(base + path, method=method,
                                             data=b"" if method == "POST" else None)
                with urllib.request.urlopen(req, timeout=300) as resp:
                    bodies.append(resp.read())
            one_srv = {k: counts()[k] - before[k] for k in ZERO}
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=60)
        del service
        got = clis[0][i]["result"]
        png_equal = got[0] == bodies[0]
        stats, one_stats = json.loads(got[-1]), json.loads(bodies[-1])
        for k in ("mean_render_s", "device"):  # the rank's cuda:0, one process's cuda
            del stats[k], one_stats[k]
        reload_equal = all(json.loads(g) == json.loads(w) for (m, _), g, w
                           in zip(requests, got, bodies) if m == "POST")
        srv_launches = [dict(ZERO, **c[i]["launches"]) for c in clis]
        gates = [DPI_GATE_LINE.findall(c[i]["stdout"]) for c in clis]
        say("dp_infer", part="e", mode=mode, requests=[p for _, p in requests],
            png_equal=png_equal, reload_equal=reload_equal, stats=stats,
            stats_equal=stats == one_stats, shape=list(decode_png(got[0]).shape),
            launches=srv_launches, one_process_launches=one_srv,
            gates=gates[0], gates_equal=gates[0] == gates[1], card=card)
        if not png_equal or not reload_equal or stats != one_stats \
                or (stats["quant"], stats["sampler"], len(gates[0])) != DPI_SERVED[mode] \
                or gates[0] != gates[1] or len(got) != len(requests) \
                or srv_launches != [one_srv, one_srv]:
            raise RuntimeError(f"dp_infer (e, {mode}): PNG equal {png_equal}, reload "
                               f"{reload_equal}, stats {stats} / {one_stats}, gates {gates}, "
                               f"launches {srv_launches} vs one process's {one_srv}")
        launches += srv_launches
    r1_files = os.listdir(os.path.join(tmp, "dpi_r1"))
    say("dp_infer", part="e", rank1_files=r1_files, wall_s_d_and_e=de_s, card=card)
    if r1_files:
        raise RuntimeError(f"dp_infer (e): rank 1 wrote {r1_files}")
    return launches


# ---------------------------------------------------------------------------
# Phase 22c: tensor parallelism (MESH_MODEL=2), two gloo ranks on the card.

# 256 rays: a split pass carries its activations through gloo, which copies
# them through the host (at 4,096 rays every collective would be hundreds of
# MB).
TP_BATCH = 256
TP_STEPS = 3
TP_SIZE = 100


def phase_tp(card: str, tmp: str) -> list[dict]:
    """Phase 22c (module docstring): the split step, eval and renders as a
    (1, 2) mesh of two gloo ranks sharing the card, against one process."""
    cfg1 = bench_config(TP_BATCH)
    cfg = dataclasses.replace(cfg1, mesh_model=2)
    cpu = Trainer(cfg1, 2.0, 6.0, device="cpu")
    # The seeded init with the fine MLP's biases random (sigma +1): the
    # init's empty field gives the fine MLP no gradient at all.
    params = cpu.params_tree()
    params["fine"] = random_params(cfg1, seed=27)["fine"]
    calib = [np.concatenate(x) for x in zip(*(
        [t.numpy() for t in cpu.pose_rays(pose_spherical(theta, -30.0, 4.0), TP_SIZE,
                                          TP_SIZE, 1.2 * TP_SIZE)]
        for theta in (0.0, 90.0, 180.0, 270.0)))]
    rays = [t.numpy() for t in cpu.pose_rays(pose_spherical(30.0, -30.0, 4.0), TP_SIZE,
                                             TP_SIZE, 1.2 * TP_SIZE)]
    del cpu
    batch = bench_batch(TP_BATCH, seed=5)
    ckpt = os.path.join(tmp, "tp.ckpt.npz")

    # The reference: one process on the card, its first step on the plain
    # path (the split's arithmetic, whole), from the same weights and draws.
    one = Trainer(cfg1, 2.0, 6.0, device="cuda").replace_params(params)
    plain = make_train_step(cfg1, 2.0, 6.0, render_pass=_plain_render_pass(cfg1))
    one_metrics = {k: float(v) for k, v in plain(one.state, one.put_batch(batch), None,
                                                 one.generator).items()}
    want = one.params_tree(grad=True)
    del one, plain
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    recs = run_ranks(2, {"device": "cuda", "backend": "gloo", "near": 2.0, "far": 6.0,
                         "jobs": [
        {"cfg": cfg, "params": params, "batch": batch, "steps": TP_STEPS, "time_steps": 10,
         "render_rays": TP_BATCH, "evaluate": True, "save": ckpt},
        {"cfg": cfg, "restore": ckpt, "infer": {"calib": calib, "rays": rays}},
        # Last: it breaks the split's backward in these processes.
        {"cfg": cfg, "params": params, "batch": batch, "steps": 1,
         "drop_model_reduce": True}]}, timeout=DP_TIMEOUT)
    wall_s = time.perf_counter() - t0
    train, infer, broken = ([r[i] for r in recs] for i in range(3))
    infer = [r["infer"] for r in infer]
    rel = [tree_rel_l2(r["grads"], want) for r in train]
    rel_broken = tree_rel_l2(broken[0]["grads"], want)
    metrics_rel = max(abs(r["metrics"][0][k] / one_metrics[k] - 1) for r in train
                      for k in one_metrics)
    replicated_equal = all(np.array_equal(v, train[1]["replicated"][k])
                           for k, v in train[0]["replicated"].items())

    # A checkpoint of the split run, reloaded in one process.
    whole = Trainer(cfg1, 2.0, 6.0, device="cuda").restore(ckpt)
    params_equal = _trees_equal(whole.params_tree(), train[0]["params"])
    whole.quantize_for_inference(*calib)
    frames = {"float": whole.render_rays(*rays), "int8": whole.render_rays(*rays, quant=True)}
    digest_equal = whole.infer_digest() == infer[0]["infer_digest"] == infer[1]["infer_digest"]
    tables_equal = all(r["digests"] == artifact_digests(whole) for r in infer)
    del whole
    torch.cuda.empty_cache()
    int8_equal = all(np.array_equal(r["frames"]["int8"][k], v) for r in infer
                     for k, v in frames["int8"].items())
    float_diff = {k: max(float(np.abs(r["frames"]["float"][k] - v).max()) for r in infer)
                  for k, v in frames["float"].items()}
    chunks = -(-TP_SIZE * TP_SIZE // 16384)
    step_launches = [g for r in train for g in r["launches"]] + [r["render_launches"]
                                                                 for r in train]
    int8_launches = [dict(ZERO, **r["steps"]["int8"]["launches"]) for r in infer]
    float_launches = [r["steps"]["float"]["launches"] for r in infer]
    audit = train[0]["audit"]
    say("tp", mesh=[1, 2], backend=train[0]["backend"], devices=[r["device"] for r in train],
        note="gloo asked for explicitly: NCCL refuses two ranks on one device; the two "
             "processes share one card and gloo copies each collective through the host, "
             "so the step ms is not a scaling figure",
        rays=TP_BATCH, samples=[cfg.ns_coarse, cfg.ns_fine], steps=TP_STEPS,
        step_ms=[r["step_ms"] for r in train], peak_mib=[r["peak_mib"] for r in train],
        collectives_per_step={axis: {k: v for k, v in c.items() if v}
                              for axis, c in audit["by_axis"].items()},
        render_collectives={"data": train[0]["render_collectives"],
                            "model": train[0]["render_model"]},
        grads_rel_l2_vs_one_process=rel, tol_rel=K2_TOL_REL,
        broken_model_reduce_rel_l2=rel_broken, metrics_max_rel_vs_one_process=metrics_rel,
        loss_curve=[m["loss"] for m in train[0]["metrics"]], eval=train[0]["eval"],
        eval_equal=train[0]["eval"] == train[1]["eval"],
        replicated_leaves_equal=replicated_equal, step_launches=step_launches[0],
        checkpoint_params_equal_one_process=params_equal, infer_digest_equal=digest_equal,
        tables_equal=tables_equal, int8_frame_equal_one_process=int8_equal,
        int8_launches=int8_launches, float_launches=float_launches,
        float_frame_max_abs_diff_vs_one_process_k1=float_diff, frame=[TP_SIZE, TP_SIZE],
        wall_s=wall_s, card=card)
    if max(rel) > K2_TOL_REL or rel_broken < 10 * K2_TOL_REL or metrics_rel > K2_TOL_REL:
        raise RuntimeError(f"tp: gradients {rel} (broken {rel_broken}) and metrics "
                           f"{metrics_rel} against one process, gate {K2_TOL_REL}")
    if any(step_launches) or any(float_launches):
        raise RuntimeError(f"tp: a split pass launched a kernel: {step_launches}, "
                           f"{float_launches}")
    if int8_launches != [dict(ZERO, k4=chunks)] * 2:
        raise RuntimeError(f"tp: the int8 frame launched {int8_launches}, expected "
                           f"{chunks} K4 a rank")
    if not (replicated_equal and params_equal and digest_equal and tables_equal
            and int8_equal and train[0]["eval"] == train[1]["eval"]):
        raise RuntimeError("tp: replicated leaves, the checkpoint, the digest, the tables, "
                           "the int8 frame or the eval differ across ranks or from one "
                           "process")
    if float_diff["rgb_fine"] > FRAME_TOL_RGB or float_diff["depth_fine"] > FRAME_TOL_DEPTH \
            or not np.isfinite(train[0]["metrics"][-1]["loss"]):
        raise RuntimeError(f"tp: the float frame is {float_diff} from one process's K1 "
                           f"frame")
    return int8_launches


# ---------------------------------------------------------------------------
# Phase 23: the union-free proposal layout (PROP_UNION=false with
# PROP_AUX_SAMPLES and PROP_UNION_EVERY).

# The arms of profile_train.ARMS at 64 + 128 (auxfree-128+32 and il4-128 from
# the JAX package's scripts/exp_coverage_step_ab.py, nounion-128 from
# docs/TRAINING.md's throughput recipe), after the shipped union recipe
# (64 + 96) as the yardstick.
UF_ARMS = (UNION_ARM, *ARMS)
UF_STEPS = 10
# The kernels' new shapes: the union-free fine pass and the aux pass (B,
# S), and the server's chunk for K4.
UF_SHAPES = ((4096, 128), (4096, 32))
UF_K4_SHAPE = (16384, 128)


class _SampleCounts:
    """Inside each ``with`` block, the samples a ray (S) of every K1, K2 and
    K4 launch, by wrapping the launch functions: ``steps`` holds a list per
    :meth:`mark` (reset on entry) and ``total`` a count by (kernel, S) over
    every block, the kernel one of ``k1_fwd``, ``k1_train``, ``k2``,
    ``k4``.  A call is counted only where the kernel's own counter grew in
    it, so ``total`` counts what the counters count.  Only main-path work
    runs inside a block."""

    # Each kernel's own launch counter.
    COUNTERS = {"k1_fwd": lambda: k1.launches - k1.train_launches,
                "k1_train": lambda: k1.train_launches,
                "k2": lambda: k1.bwd_launches, "k4": lambda: k4.launches}

    def __init__(self):
        self.steps: list[list] = [[]]
        self.total: dict = {}

    def mark(self) -> None:
        self.steps.append([])

    def _wrap(self, fn, name):
        def wrapped(*args, **kw):
            kernel = name
            if name == "k1":
                train = kw.get("train", args[6] if len(args) > 6 else False)
                kernel = "k1_train" if train else "k1_fwd"
            before = self.COUNTERS[kernel]()
            out = fn(*args, **kw)
            grew = self.COUNTERS[kernel]() - before
            if grew not in (0, 1):
                raise RuntimeError(f"one {kernel} call counted {grew} launches")
            if grew:
                key = (kernel, int(args[3].shape[-1]))
                self.steps[-1].append(key)
                self.total[key] = self.total.get(key, 0) + 1
            return out
        return wrapped

    def __enter__(self):
        self.steps = [[]]
        self._real = (k1.launch_k1, k1.launch_k2, k4.launch_k4)
        k1.launch_k1 = self._wrap(self._real[0], "k1")
        k1.launch_k2 = self._wrap(self._real[1], "k2")
        k4.launch_k4 = self._wrap(self._real[2], "k4")
        return self

    def __exit__(self, *exc):
        k1.launch_k1, k1.launch_k2, k4.launch_k4 = self._real


def _uf_kernels(card: str) -> dict:
    """(a) K1 forward, K1 in training mode and K2 at B=4096, S=128 and 32,
    and K4 at B=16384, S=128, each against its plain version with the
    gates of phases 3, 4 and 11; CUDA-event times, bounds and library
    yardsticks."""
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(14)
    mlp = full_mlp(dev, 14)
    params = list(mlp.parameters())
    _, origins, dirs = (torch.as_tensor(x, device=dev) for x in bench_batch(4096, seed=14))
    desc = k1.kernel_pack(mlp, dev).desc
    report = {}
    for b, s in UF_SHAPES:
        t = generate_t_vals(2.0, 6.0, (b,), s, "stratified", generator=gen).to(dev).contiguous()
        args = (mlp, origins, dirs, t)
        with torch.inference_mode():
            rgb_k, w_k = k1.render_rays_fused(*args)
            rgb_p, w_p = k1.render_rays_reference(*args)
            d_rgb, d_w = (rgb_k - rgb_p).abs(), (w_k - w_p).abs()
            fwd = {"rgb_max": d_rgb.max().item(), "rgb_mean": d_rgb.mean().item(),
                   "w_max": d_w.max().item(), "w_mean": d_w.mean().item()}
            fwd_ms = cuda_ms(lambda: k1.render_rays_fused(*args))
            fwd_plain_ms = cuda_ms(lambda: k1.render_rays_reference(*args))
        g_rgb = (torch.randn((b, 3), generator=gen) * 1e-3).to(dev)
        g_w = (torch.randn((b, s), generator=gen) * 1e-3).to(dev)
        with torch.no_grad():
            _, _, x_enc, preds = k1.launch_k1(mlp, origins, dirs, t, 10, 4, train=True)
            got = k1.launch_k2(mlp, x_enc, dirs, t, preds, g_rgb, g_w, 10, 4)
            d_enc = encode_position(dirs, 4)[:, None, :].expand(b, s, -1).reshape(b * s, -1)
            preds_err = float((preds - mlp(x_enc.float(), d_enc)).abs().max())
            train_ms = cuda_ms(lambda: k1.launch_k1(mlp, origins, dirs, t, 10, 4, train=True))
            k2_ms = cuda_ms(lambda: k1.launch_k2(mlp, x_enc, dirs, t, preds, g_rgb, g_w, 10, 4))
        with torch.enable_grad():
            rgb_p, w_p = k1.render_rays_reference(*args)
        want = list(torch.autograd.grad([rgb_p, w_p], params, [g_rgb, g_w], retain_graph=True))
        max_abs, rel = _leaf_errors(got, want)
        plain_bwd_ms = cuda_ms(lambda: torch.autograd.grad(
            [rgb_p, w_p], params, [g_rgb, g_w], retain_graph=True))
        del rgb_p, w_p, want, x_enc, preds, d_enc
        torch.cuda.empty_cache()
        entry = {"fwd_err": max(fwd["rgb_max"], fwd["w_max"]), "fwd_ms": fwd_ms,
                 "fwd_plain_ms": fwd_plain_ms, "fwd_bound": k1_bound(mlp, b, s, False),
                 "train_err": preds_err, "train_ms": train_ms, "train_plain_ms": fwd_plain_ms,
                 "train_bound": k1_bound(mlp, b, s, True), "k2_err": max_abs, "k2_ms": k2_ms,
                 "k2_plain_ms": plain_bwd_ms, "k2_bound": k2_bound(mlp, b, s),
                 "library_ms": library_products_ms(desc, b * s, torch.bfloat16, dev),
                 "dw_library_ms": _dw_library_ms(mlp, dev, b * s)}
        report[s] = entry
        say("union_free_k1_k2", B=b, S=s, **fwd, tol_max=TOL_MAX, tol_mean=TOL_MEAN,
            k1_ms=fwd_ms, k1_plain_ms=fwd_plain_ms, k1_bound_ms=entry["fwd_bound"][0],
            k1_train_ms=train_ms, k1_train_bound_ms=entry["train_bound"][0],
            preds_max_err=preds_err, k2_max_abs_err=max_abs, k2_max_rel_l2=rel,
            tol_rel=K2_TOL_REL, k2_ms=k2_ms, k2_plain_bwd_ms=plain_bwd_ms,
            k2_bound_ms=entry["k2_bound"][0], library_products_ms=entry["library_ms"],
            library_dw_ms=entry["dw_library_ms"], card=card)
        if (fwd["rgb_max"] > TOL_MAX or fwd["w_max"] > TOL_MAX or fwd["rgb_mean"] > TOL_MEAN
                or fwd["w_mean"] > TOL_MEAN):
            raise RuntimeError(f"K1 disagrees with the plain version at S={s}: {fwd}")
        if preds_err > PREDS_TOL or rel > K2_TOL_REL or not np.isfinite(max_abs):
            raise RuntimeError(f"K1-train/K2 disagree with the plain versions at S={s}: "
                               f"preds {preds_err}, rel L2 {rel}")

    b, s = UF_K4_SHAPE
    qp = _calibrated_qparams(mlp, dev)
    o, d = get_rays(128, 128, 153.6, pose_spherical(30.0, -30.0, 4.0), device=dev)
    o, d = o.reshape(-1, 3).contiguous(), d.reshape(-1, 3).contiguous()
    t = generate_t_vals(2.0, 6.0, (b,), s, "stratified", generator=gen).to(dev).contiguous()
    args = (qp, o, d, t)
    errs = _errs(k4.render_rays_fused_quant(*args), k4.render_rays_reference_quant(*args))
    ms = cuda_ms(lambda: k4.render_rays_fused_quant(*args))
    plain_ms = cuda_ms(lambda: k4.render_rays_reference_quant(*args))
    bnd = k4_bound(mlp, b, s)
    library = library_products_ms(k4.kernel_pack(qp, dev).desc, b * s, torch.int8, dev)
    report["k4"] = {"err": max(errs["rgb_max"], errs["w_max"]), "ms": ms, "plain_ms": plain_ms,
                    "bound": bnd, "library_ms": library}
    say("union_free_k4", B=b, S=s, **errs, tol_max=K4_TOL_MAX, tol_mean=K4_TOL_MEAN, ms=ms,
        plain_ms=plain_ms, bound_ms=bnd[0], bound_by=bnd[1], library_ms=library, card=card)
    if _miss(errs) > 1.0:
        raise RuntimeError(f"K4 disagrees with the plain version at B={b}, S={s}: {errs}")
    return report


def _uf_expected_samples(cfg, step: int) -> list:
    """The (kernel, S) launches of one proposal train step, sorted."""
    if union_step(cfg, step):
        s = [cfg.ns_coarse + cfg.ns_fine]
    else:
        s = [cfg.ns_fine] + ([aux_samples(cfg, step)] if aux_samples(cfg, step) else [])
    return sorted([("k1_train", x) for x in s] + [("k2", x) for x in s])


def _uf_arms(card: str, rec: _SampleCounts) -> tuple[list[dict], Trainer, tuple]:
    """(b) Each arm on one fixed bench batch: one step's gradients, kernel
    path against plain path with the same draws; 10 steps with exact
    launches and samples a ray by step; a falling loss, the median step and
    the peak memory.  Returns the launches, the nounion-128 trainer and the
    batch."""
    runs, kept = [], None
    for name in UF_ARMS:
        cfg = arm_config(name)
        trainer = Trainer(cfg, 2.0, 6.0, device="cuda")
        batch = trainer.put_batch(bench_batch(cfg.batch_size))
        losses, by_model, max_abs, _ = _grads_kernel_vs_plain(
            cfg, trainer, batch, [(cfg.batch_size, cfg.ns_fine)], seed=15)
        rel = max(max(v) for v in by_model.values())
        n = 2 if cfg.prop_aux_samples else 1

        def step_fn(state, batch_, draws, generator, trainer=trainer):
            rec.mark()
            return trainer.train_step(batch_)

        with rec:
            run = _train_steps(trainer, batch, UF_STEPS, dict(ZERO, k1_train=n, k2=n), step_fn)
        samples = [sorted(s) for s in rec.steps[1:]]
        want = [_uf_expected_samples(cfg, i) for i in range(UF_STEPS)]
        say("union_free_arm", arm=name, ns_coarse=cfg.ns_coarse, ns_fine=cfg.ns_fine,
            prop_union=cfg.prop_union, prop_aux_samples=cfg.prop_aux_samples,
            prop_union_every=cfg.prop_union_every, loss_kernel=losses[0],
            loss_plain=losses[1], grads_max_abs_err=max_abs, grads_max_rel_l2=rel,
            tol_rel=STEP_TOL_REL, samples_by_step=[[x[1] for x in s if x[0] == "k1_train"]
                                                   for s in samples],
            **run, card=card)
        if rel > STEP_TOL_REL:
            raise RuntimeError(f"{name}: kernel-path gradients disagree with the plain "
                               f"path: {rel}")
        if samples != want:
            raise RuntimeError(f"{name}: launched at samples {samples}, expected {want}")
        if not run["loss_curve"][-1] < run["loss_curve"][0]:
            raise RuntimeError(f"{name}: the loss did not fall: {run['loss_curve']}")
        if run["peak_step_mib"] > STEP_PEAK_MIB:
            raise RuntimeError(f"{name}: a step peaked at {run['peak_step_mib']} MiB")
        runs.append(run["launches"])
        if name == "nounion-128":
            kept = (trainer, batch)
        del trainer
        torch.cuda.empty_cache()
    return runs, *kept


def _uf_serving(card: str, tmp: str, trainer: Trainer, batch, rec: _SampleCounts) -> list:
    """(c) The nounion-128 trainer: ``evaluate`` and a 200x200 frame (K1
    only, S=128), the int8 frame after ``quantize_for_inference`` (K4 only,
    the PSNR gate), a checkpoint, one /render from the server on it, and
    ``cli.evaluate`` and ``cli.infer`` (3 frames) on it."""
    n_chunks = -(-200 * 200 // 16384)
    with rec:
        ev, launches = _eval_and_frame(trainer, batch, "union_free")
    say("union_free_eval_frame", eval=ev, launches=launches,
        samples=sorted(set(rec.steps[0])), card=card)
    if launches != dict(ZERO, k1_fwd=1 + n_chunks) or set(rec.steps[0]) != {("k1_fwd", 128)}:
        raise RuntimeError(f"union_free (c): eval and frame launched {launches} at "
                           f"{set(rec.steps[0])}, expected K1 only at S=128")
    runs = [launches, phase_proposal_int8(card, trainer, "union_free_int8", rec)]

    root = os.path.join(tmp, "union_free")
    os.makedirs(root)
    config = _config_file(os.path.join(root, "union_free.json"), TRAIN_SAMPLER="proposal",
                          PROP_UNION=False, PROP_EXPLORE=0.1, DISTORTION_LOSS_MULT=1e-4,
                          PROP_ANNEAL_STEPS=1000, WITH_GCS=False)
    ckpt = os.path.join(root, "nounion.ckpt.npz")
    trainer.save(ckpt, scene={"near": 2.0, "far": 6.0, "focal": 120.0})
    service = RenderService(load_config(config), ckpt, device="cuda")
    server = serve(service, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        reset_counts()
        with rec:
            png, seconds = _get(f"http://127.0.0.1:{server.server_address[1]}/render?"
                                f"theta=30&phi=-30&radius=4&width=200&height=200")
        launches = counts()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    img = decode_png(png)
    say("union_free_serve", latency_s=seconds, shape=list(img.shape), launches=launches,
        std=float(img.std()), card=card)
    if launches != dict(ZERO, k1_fwd=n_chunks) or img.shape != (200, 200, 3) or img.std() == 0:
        raise RuntimeError(f"union_free (c): /render launched {launches}, {img.shape}")
    runs.append(launches)

    with rec:
        report, _, launches = _cli(eval_cli.run_evaluation, [
            "--config", config, "--checkpoint", ckpt, "--data", "synthetic", "--split",
            "val", "--device", "cuda", "--out", os.path.join(root, "eval.json")])
    views = len(report["views"])
    say("union_free_cli_evaluate", launches=_clean(launches), views=views,
        mean=report["mean"], card=card)
    if _clean(launches) != dict(ZERO, k1_fwd=views) or not np.isfinite(report["mean"]["psnr"]):
        raise RuntimeError(f"union_free (c): cli.evaluate launched {launches}, "
                           f"report {report['mean']}")
    runs.append(_clean(launches))
    video = os.path.join(root, "orbit.mp4")
    with rec, _captured_frames() as handed:
        written, _, launches = _cli(infer_cli.run_inference, [
            "--config", config, "--checkpoint", ckpt, "--frames", "3", "--device", "cuda",
            "--out", video])
    back = _video_back(written, handed[video], "union_free (c)")
    say("union_free_cli_infer", launches=_clean(launches), written=os.path.basename(written),
        video=back, card=card)
    if _clean(launches) != dict(ZERO, k1_fwd=3) or len(handed[video]) != 3:
        raise RuntimeError(f"union_free (c): cli.infer launched {launches}, wrote {back}")
    runs.append(_clean(launches))
    return runs


def _uf_train_cli(card: str, tmp: str, rec: _SampleCounts) -> dict:
    """(d) ``cli.train_synthetic`` for 1 epoch on a config JSON with the
    three knobs (aux 32, a union step every 4th) and an auto anneal
    horizon: the launches its steps, eval and panels imply, a finite loss."""
    config = _config_file(os.path.join(tmp, "union_free_train.json"),
                          TRAIN_SAMPLER="proposal", PROP_UNION=False, PROP_EXPLORE=0.1,
                          PROP_AUX_SAMPLES=32, PROP_UNION_EVERY=4, PROP_ANNEAL_STEPS=-1,
                          DISTORTION_LOSS_MULT=1e-4, WITH_GCS=False)
    cfg = dataclasses.replace(load_config(config), epochs=1)
    expected, steps = _expected_launches(
        cfg, train_synthetic.prepare, 1, 1, passes=1,
        train_passes=lambda i: 1 if i % 4 == 0 else 2)
    run = os.path.join(tmp, "union_free_run")
    with rec:
        trainer, out, launches = _cli(train_synthetic.main, [
            "--config", config, "--run-dir", run, "--epochs", "1", "--eval-every", "1"])
    history = History.load(os.path.join(run, _history_name(cfg)))
    epochs = [{"epoch": int(m[0]), "krays_per_s": float(m[1]), "step_ms": float(m[2])}
              for m in EPOCH_LINE.findall(out)]
    say("union_free_train_cli", steps=steps, epochs=epochs, launches=launches,
        expected=expected, prop_anneal_steps=trainer.cfg.prop_anneal_steps,
        losses=history.losses, val_psnrs=history.val["psnrs"], card=card)
    if launches != expected:
        raise RuntimeError(f"union_free (d): launched {launches}, expected {expected}")
    if trainer.cfg.prop_anneal_steps != steps or not np.isfinite(history.losses).all():
        raise RuntimeError(f"union_free (d): horizon {trainer.cfg.prop_anneal_steps} "
                           f"(expected {steps}), losses {history.losses}")
    return _clean(launches)


def phase_union_free(card: str, tmp: str) -> tuple[list[dict], dict]:
    """Phase 23 (module docstring): returns the main path's launches and a
    report of the kernels' new shapes, with each one's launches by S."""
    t0 = time.perf_counter()
    report = _uf_kernels(card)
    torch.cuda.empty_cache()
    rec = _SampleCounts()
    runs, trainer, batch = _uf_arms(card, rec)
    runs += _uf_serving(card, tmp, trainer, batch, rec)
    del trainer
    torch.cuda.empty_cache()
    runs.append(_uf_train_cli(card, tmp, rec))
    report["launches"] = rec.total
    say("union_free", wall_s=time.perf_counter() - t0,
        launches_by_kernel_and_samples={f"{k}@S={s}": v for (k, s), v in rec.total.items()},
        card=card)
    return runs, report


# The Keras fixtures' golden forwards: the JAX package's own tolerance for
# them (tests/test_keras_import.py), float32 against Keras' float32.
KERAS_GOLDEN_TOL = 2e-4
# The orbit's GIF against the frames rendered: 45.74 dB at worst on an
# H100's host; a median cut that had lost its way sits far below.
VIDEO_PSNR_FLOOR_DB = 35.0


class _Handed(dict):
    """The uint8 frames ``cli.infer`` hands to ``write_video``, by the path
    it asks for; ``seconds`` the time ``write_video`` took for each."""

    def __init__(self):
        super().__init__()
        self.seconds = {}


@contextlib.contextmanager
def _captured_frames():
    """:class:`_Handed` for the ``cli.infer`` calls inside; the CLI still
    writes them."""
    frames, write = _Handed(), infer_cli.write_video

    def capture(path, images, fps):
        frames[path] = [np.array(f) for f in images]
        t0 = time.perf_counter()
        written = write(path, images, fps)
        frames.seconds[path] = time.perf_counter() - t0
        return written

    infer_cli.write_video = capture
    try:
        yield frames
    finally:
        infer_cli.write_video = write


def _video_back(written: str, handed: list, what: str) -> dict:
    """``read_gif`` of what ``cli.infer`` wrote (the port's GIF: the card's
    machine has no mp4 encoder): the frames handed to ``write_video``, each
    as the writer's own palette mapping, bit for bit, repeats merged, loop
    0.  Raises otherwise; returns the frame count, durations and bytes."""
    if not written.endswith(".gif"):
        raise RuntimeError(f"{what}: cli.infer wrote {written}, not the port's GIF")
    got, durations, loop = read_gif(written)
    want = shown_frames(handed)
    if len(got) != len(want) or loop != 0 or \
            not all(np.array_equal(g, w) for g, w in zip(got, want)):
        raise RuntimeError(f"{what}: {written} reads back {len(got)} frames (loop {loop}), "
                           f"not the {len(want)} frames written")
    return {"frames": len(got), "durations_ms": durations, "bytes": os.path.getsize(written)}


def _trees_equal(a: dict, b: dict) -> bool:
    fa, fb = _flatten(a, ""), _flatten(b, "")
    return fa.keys() == fb.keys() and all(
        fa[k].dtype == fb[k].dtype and np.array_equal(fa[k], fb[k]) for k in fa)


def _bn_params(cfg, seed: int) -> tuple[dict, dict]:
    """Seeded BatchNorm params (random biases, gamma, beta) and running
    statistics at ``cfg``'s widths."""
    rng = np.random.default_rng(seed)
    params = random_params(cfg, seed)
    stats = {}
    for name, tree in params.items():
        layers = [*tree["trunk"], tree["branch"]]
        for layer in layers:
            width = layer["b"].shape[0]
            layer["gamma"] = rng.uniform(0.5, 1.5, width).astype(np.float32)
            layer["beta"] = rng.normal(0.0, 0.1, width).astype(np.float32)
        moments = [{"mean": rng.normal(0.0, 0.3, layer["b"].shape).astype(np.float32),
                    "var": rng.uniform(0.5, 2.0, layer["b"].shape).astype(np.float32)}
                   for layer in layers]
        stats[name] = {"trunk": moments[:-1], "branch": moments[-1]}
    return params, stats


def phase_keras(card: str, tmp: str, runs_dirs: dict[str, tuple[str, str]]) -> list[dict]:
    """Phase 24 (module docstring): (a)-(d); ``runs_dirs`` maps a name to
    (config, run directory) of phase 19.  Returns the main paths' launches."""
    root = os.path.dirname(os.path.abspath(__file__))
    fixtures = os.path.join(root, "tests", "fixtures")
    dev = torch.device("cuda")
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise RuntimeError("keras (a): TF32 is on; the golden forwards need float32 products")
    golden = np.load(os.path.join(fixtures, "ref_tiny_golden.npz"))
    x = torch.tensor(golden["x_enc"], device=dev)
    d = torch.tensor(golden["d_enc"], device=dev)
    errs = {}
    for variant in ("plain", "bn"):
        tiny = NeRFConfig(num_layers=6, hidden_dim=32, skip_layer=4, l_xyz=10, l_dir=4,
                          compute_dtype="float32", batch_norm=variant == "bn")
        params, stats = import_reference_weights(
            os.path.join(fixtures, f"ref_tiny_{variant}.weights.h5"), tiny)
        for which in ("coarse", "fine"):
            mlp = NeRFMLP.from_jax_params(params[which], skip_layer=4,
                                          compute_dtype=torch.float32, device=dev,
                                          bn_state=None if stats is None else stats[which])
            with torch.no_grad():
                out = mlp(x, d).cpu().numpy()
            want = golden[f"out_{which}_{variant}"]
            diff = np.abs(out - want)
            errs[f"{which}_{variant}"] = {
                "max_abs_err": float(diff.max()), "max_abs_golden": float(np.abs(want).max()),
                # the largest |diff| / (atol + rtol |golden|): the gate at 1
                "gate_share": float((diff / (KERAS_GOLDEN_TOL * (1 + np.abs(want)))).max())}
            if not errs[f"{which}_{variant}"]["gate_share"] <= 1.0:
                raise RuntimeError(f"keras (a): {which} {variant} is {errs} from the golden "
                                   "forward")
    say("keras_fixtures", errors=errs, rtol=KERAS_GOLDEN_TOL, atol=KERAS_GOLDEN_TOL,
        hidden=32, card=card)

    # (b) full width: export, import, then the CLI on the file.
    cfg = load_config(CONFIG)
    focal = 1.2 * max(cfg.height, cfg.width)
    params = random_params(cfg, seed=24)
    path = os.path.join(tmp, "keras_ref.weights.h5")
    export_ms = _host_ms(lambda: export_reference_weights(path, params, cfg), reps=3)
    import_ms = _host_ms(lambda: import_reference_weights(path, cfg), reps=3)
    imported, none = import_reference_weights(path, cfg)
    if none is not None or not _trees_equal(imported, params):
        raise RuntimeError("keras (b): the full-width file does not re-import exactly")
    runs = []
    per_frame = 2 * math.ceil(cfg.height * cfg.width / 16384)
    base = ["--config", CONFIG, "--reference-weights", path, "--frames", "3"]
    with _captured_frames() as frames:
        _, out_f, launches = _cli(infer_cli.run_inference,
                                  base + ["--out", os.path.join(tmp, "keras_f.mp4")])
    runs.append(_clean(launches))
    frame_ms = [float(v) for v in FRAME_MS.findall(out_f)]
    trainer = Trainer(resolve_infer_config(cfg, None)[0], 2.0, 6.0, device=dev)
    trainer.replace_params(params)
    want = [to_uint8(trainer.render_image(pose, cfg.height, cfg.width, focal,
                                          uint8_rgb=True, need_depth=False)["rgb"])
            for pose in infer_cli.spherical_poses(3)]
    got = next(iter(frames.values()))
    same = len(got) == 3 and all(np.array_equal(a, b) for a, b in zip(got, want))
    if runs[-1] != dict(ZERO, k1_fwd=3 * per_frame) or not same \
            or "imported reference weights" not in out_f:
        raise RuntimeError(f"keras (b): launched {runs[-1]}, frames equal to replace_params: "
                           f"{same}")
    with _captured_frames() as frames:
        _, out_q, launches = _cli(infer_cli.run_inference, base + [
            "--quant", "int8", "--out", os.path.join(tmp, "keras_q.mp4")])
    runs.append(_clean(launches))
    gates = {g[0]: {"decision": g[1], "psnr_db": float(g[2])} for g in GATE_LINE.findall(out_q)}
    q = gates.get("int8", {}).get("decision") == "PASS"
    want_q = dict(ZERO, k1_fwd=per_frame * (1 if q else 4), k4=per_frame * (4 if q else 1))
    got_q = next(iter(frames.values()))
    if len(gates) != 1 or runs[-1] != want_q or len(got_q) != 3:
        raise RuntimeError(f"keras (b): int8 gates {gates}, launched {runs[-1]}, expected "
                           f"{want_q}")
    del trainer
    torch.cuda.empty_cache()

    # (c) a BatchNorm file: the plain MLP, no kernel.
    bn_config = _config_file(os.path.join(tmp, "keras_bn.json"), BATCH_NORM=True,
                             WITH_GCS=False)
    bn_cfg = load_config(bn_config)
    bn_params, bn_stats = _bn_params(bn_cfg, seed=25)
    bn_path = os.path.join(tmp, "keras_bn.weights.h5")
    export_reference_weights(bn_path, bn_params, bn_cfg, bn_state=bn_stats)
    with _captured_frames() as frames:
        _, out_bn, launches = _cli(infer_cli.run_inference, [
            "--config", bn_config, "--reference-weights", bn_path, "--frames", "1",
            "--out", os.path.join(tmp, "keras_bn.mp4")])
    runs.append(_clean(launches))
    bn_trainer = Trainer(resolve_infer_config(bn_cfg, None)[0], 2.0, 6.0, device=dev)
    bn_trainer.replace_params(bn_params, bn_stats)
    bn_want = to_uint8(bn_trainer.render_image(
        infer_cli.spherical_poses(1)[0], bn_cfg.height, bn_cfg.width,
        1.2 * max(bn_cfg.height, bn_cfg.width), uint8_rgb=True, need_depth=False)["rgb"])
    bn_got = next(iter(frames.values()))[0]
    bn_diff = int(np.abs(bn_got.astype(np.int16) - bn_want.astype(np.int16)).max())
    if runs[-1] != ZERO or bn_diff > 1 or bn_got.shape != (bn_cfg.height, bn_cfg.width, 3):
        raise RuntimeError(f"keras (c): launched {runs[-1]}, frame {bn_got.shape} "
                           f"{bn_diff} levels from replace_params")
    del bn_trainer
    torch.cuda.empty_cache()

    # (d) cli.export_keras on phase 19's run directories.
    exported = {}
    for name, (config, run) in runs_dirs.items():
        out = os.path.join(tmp, f"keras_export_{name}.weights.h5")
        _, _, launches = _cli(export_cli.run_export, ["--config", config, "--checkpoint",
                                                      run, "--out", out])
        runs.append(_clean(launches))
        ckpt = resolve_checkpoint(run)
        run_cfg = resolve_infer_config(load_config(config), ckpt)[0]
        source = Trainer(run_cfg, 2.0, 6.0, device=dev).restore(ckpt)
        got_p, got_bn = import_reference_weights(out, run_cfg)
        want_bn = source.bn_tree()
        exact = _trees_equal(got_p, models_to_jax(source.eval_params)) and (
            got_bn is None if want_bn is None else _trees_equal(got_bn, want_bn))
        exported[name] = {"checkpoint": os.path.basename(ckpt), "batch_norm": run_cfg.batch_norm,
                          "exact": exact, "bytes": os.path.getsize(out)}
        if runs[-1] != ZERO or not exact:
            raise RuntimeError(f"keras (d): {name} launched {runs[-1]}, {exported[name]}")
        del source
    say("keras", import_ms=import_ms, export_ms=export_ms, frame_ms=frame_ms,
        median_frame_ms=statistics.median(frame_ms), file_bytes=os.path.getsize(path),
        float_launches=runs[0], int8_gates=gates, int8_launches=runs[1],
        bn_launches=runs[2], bn_frame_levels_from_replace_params=bn_diff,
        exported=exported, card=card)
    return runs


# ---------------------------------------------------------------------------
# Phases 26 and 27: any hidden width up to 256 (the zero-padded wgmma packs)
# and COMPUTE_DTYPE=float32 (the f32 kernels).

# The f32 kernels against their plain versions, relative L2 on every output
# and gradient.  The yardstick is the plain version (f32 products, TF32
# off: per sample the kernels' arithmetic) with its weight- and
# bias-gradient sums over the batch and its compositing taken in float64
# (``_f64_yardstick``): the plain f32 version's own sums over 786,432
# samples err by ~1e-5 on the sigma head's gradient (the sum of dsigma x h
# cancels ~100x; two plain f32 runs that differ only in the order of the
# rays differ by 5e-6 at 196,608 samples), and so does its f32 compositing
# VJP (2e-6 from float64 at 196,608 samples).  Each kernel's distance to
# the plain f32 version is reported beside it.  Products in float64 would
# be no yardstick: they move pre-activations by an f32 ulp, which flips a
# few hundred ReLU masks and the gradients by ~3e-4.
F32_TOL_REL = 1e-5
# One f32 train step's gradients, kernel path against plain path with the
# same draws: the fine samples follow the coarse weights through
# sample_pdf, which carries the kernels' rounding differences on.
F32_STEP_TOL_REL = 1e-3
WIDTHS_PADDED = (16, 96, 192)
WIDTHS_NATIVE = (64, 128, 256)
WIDTHS_WIDE = (320, 512, 1024)  # the split tile: 320 padded to 512, 512 and 1024 native


def peak_f32() -> float:
    """The card's f32 FFMA peak, SMs x 128 lanes x 2 x the maximum SM clock
    (nvidia-smi), FLOP/s: about 66.9e12 on an H100 SXM."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         check=True).stdout
    return sms * 128 * 2 * float(out.splitlines()[0]) * 1e6


def _suite_mlp(dev, hidden: int, seed: int, dtype=torch.bfloat16, l_xyz: int = 10,
               l_dir: int = 4) -> NeRFMLP:
    gen = torch.Generator().manual_seed(seed)
    return randomize_biases_(
        NeRFMLP(num_layers=8, hidden_dim=hidden, skip_layer=4, l_xyz=l_xyz, l_dir=l_dir,
                compute_dtype=dtype, generator=gen, device=dev), gen)


def _suite_inputs(mlp: NeRFMLP, b: int, s: int, seed: int) -> dict:
    """Rays, t-values, cotangents (rgb, weights, K5's predictions) and the
    per-sample encodings in the MLP's compute dtype."""
    dev = next(mlp.parameters()).device
    _, o, d = (torch.as_tensor(x, device=dev) for x in bench_batch(b, seed))
    gen = torch.Generator().manual_seed(seed)
    t = generate_t_vals(2.0, 6.0, (b,), s, "stratified", generator=gen).to(dev).contiguous()
    dt = mlp.compute_dtype
    pts = o[:, None, :] + d[:, None, :] * t[..., None]
    return {
        "o": o, "d": d, "t": t,
        "g_rgb": (torch.randn((b, 3), generator=gen) * 1e-3).to(dev),
        "g_w": (torch.randn((b, s), generator=gen) * 1e-3).to(dev),
        "g5": (torch.randn((b * s, 4), generator=gen) * 1e-2).to(dev),
        "x_enc": encode_position(pts, mlp.l_xyz).to(dt).contiguous(),
        "d_enc": encode_position(d, mlp.l_dir)[:, None, :].expand(b, s, -1).to(dt).contiguous(),
    }


SUITE = ("k1", "k1_train", "k2", "k3", "k6_fwd", "k6_bwd", "k5_fwd", "k5_bwd")


def _k5_input_grads(mlp: NeRFMLP) -> bool:
    """Whether the suite's K5 backward takes input gradients: up to hidden
    256 (``fused_render.MAX_HIDDEN_IG``; wider raises)."""
    return mlp.hidden_dim <= k1.MAX_HIDDEN_IG


def _suite_calls(mlp: NeRFMLP, x: dict) -> dict:
    """Each kernel of the suite as a call on ``x``'s inputs, returning its
    outputs as a list: K1 (rgb, weights), K1 in training mode (with its
    predictions), K2 and K3 (gradients of <rgb, g_rgb> + <weights, g_w>
    from K1's residuals), K6 forward and backward (over the per-sample
    encodings), K5 forward and backward, with input gradients up to
    hidden 256 (:func:`_k5_input_grads`)."""
    o, d, t, g_rgb, g_w = x["o"], x["d"], x["t"], x["g_rgb"], x["g_w"]
    lx, ld = mlp.l_xyz, mlp.l_dir
    b, s = t.shape
    x2, d2 = x["x_enc"].reshape(b * s, -1), x["d_enc"].reshape(b * s, -1)
    res = {}

    def k1_train():
        rgb, w, x_res, preds = k1.launch_k1(mlp, o, d, t, lx, ld, train=True)
        res["k2"] = (x_res, preds)
        return [rgb, w, preds]

    def k2():
        if "k2" not in res:
            k1_train()
        return k1.launch_k2(mlp, res["k2"][0], d, t, res["k2"][1], g_rgb, g_w, lx, ld)

    def k3():
        _, _, _, preds = k1.launch_k1(mlp, o, d, t, lx, ld, train=True, emit_xenc=False)
        return k1.launch_k3(mlp, o, d, t, preds, g_rgb, g_w, lx, ld)

    def k6_bwd():
        _, _, preds = k1.launch_k6_fwd(mlp, x["x_enc"], x["d_enc"], t, train=True)
        return k1.launch_k6_bwd(mlp, x["x_enc"], x["d_enc"], t, preds, g_rgb)

    def k5_bwd():
        ig = _k5_input_grads(mlp)
        grads, dx, dd = k5.launch_k5_bwd(mlp, x2, d2, x["g5"], ig, ig)
        return grads + ([dx, dd] if ig else [])

    return {
        "k1": lambda: list(k1.render_rays_fused(mlp, o, d, t, l_xyz=lx, l_dir=ld,
                                                skip_layer=mlp.skip_layer)),
        "k1_train": k1_train,
        "k2": k2,
        "k3": k3,
        "k6_fwd": lambda: list(k1.apply_nerf_render_fused(mlp, x["x_enc"], x["d_enc"], t)),
        "k6_bwd": k6_bwd,
        "k5_fwd": lambda: [k5.launch_k5_fwd(mlp, x2, d2)],
        "k5_bwd": k5_bwd,
    }


def _suite_plain(mlp: NeRFMLP, x: dict) -> dict:
    """The plain versions of :func:`_suite_calls`, as calls."""
    o, d, t, g_rgb, g_w = x["o"], x["d"], x["t"], x["g_rgb"], x["g_w"]
    kw = dict(l_xyz=mlp.l_xyz, l_dir=mlp.l_dir, skip_layer=mlp.skip_layer)
    b, s = t.shape
    x2, d2 = x["x_enc"].reshape(b * s, -1), x["d_enc"].reshape(b * s, -1)

    def k1_train():
        with torch.no_grad():
            rgb, w = k1.render_rays_reference(mlp, o, d, t, **kw)
            return [rgb, w, mlp(x2, d2)]

    def k5_bwd():
        ig = _k5_input_grads(mlp)
        grads, dx, dd = k5.apply_nerf_mlp_reference_vjp(mlp, x2, d2, x["g5"], ig)
        return grads + ([dx, dd] if ig else [])

    def no_grad(fn):
        def call():
            with torch.no_grad():
                return fn()
        return call

    vjp = lambda: k1.render_rays_reference_vjp(mlp, o, d, t, g_rgb, g_w, **kw)  # noqa: E731
    return {
        "k1": no_grad(lambda: list(k1.render_rays_reference(mlp, o, d, t, **kw))),
        "k1_train": k1_train,
        "k2": vjp,
        "k3": vjp,
        "k6_fwd": no_grad(lambda: list(k1.apply_nerf_render_reference(
            mlp, x["x_enc"], x["d_enc"], t))),
        "k6_bwd": lambda: k1.apply_nerf_render_reference_vjp(mlp, x["x_enc"], x["d_enc"], t,
                                                             g_rgb),
        "k5_fwd": no_grad(lambda: [mlp(x2, d2)]),
        "k5_bwd": k5_bwd,
    }


def _suite_errors(got: list, want: list) -> dict:
    """Max |diff|, mean |diff| (over the first two outputs: rgb/weights or
    predictions) and the largest relative L2 over the outputs."""
    rel = [_rel_l2(a, w) for a, w in zip(got, want)]
    return {"max_abs": max(float((a.float() - w.float()).abs().max()) for a, w in zip(got, want)),
            "mean_abs": max(float((a.float() - w.float()).abs().mean())
                            for a, w in zip(got[:2], want[:2])),
            "rel_l2": max(rel), "rel_l2_each": rel}


def _bf16_gate_miss(name: str, e: dict) -> float:
    """How far the suite's error figures are beyond K1-K6's bf16 gates (the
    same gates phases 3-5, 14 and 15 hold them to; 1 = at the gate)."""
    if name in ("k1", "k6_fwd", "k1_train"):
        return max(e["mean_abs"] / TOL_MEAN,
                   e["max_abs"] / (PREDS_TOL if name == "k1_train" else TOL_MAX))
    if name == "k5_fwd":
        return max(e["max_abs"] / K5_PREDS_MAX, e["mean_abs"] / K5_PREDS_MEAN)
    return e["rel_l2"] / (K5_TOL_REL if name == "k5_bwd" else K2_TOL_REL)


def _bf16_gate_ok(name: str, e: dict) -> bool:
    """K1-K6's bf16 gates, by the suite's error figures."""
    return _bf16_gate_miss(name, e) <= 1.0


@contextlib.contextmanager
def _forward_pack(pack: k1.KernelPack):
    """Every bf16 kernel (K1, K5, K6 and the backwards' recompute) reads
    ``pack`` as the MLP's forward pack inside the block."""
    saved = k1.kernel_pack, k5.kernel_pack
    k1.kernel_pack = k5.kernel_pack = lambda mlp, device: pack
    try:
        yield
    finally:
        k1.kernel_pack, k5.kernel_pack = saved


def _broken_wide_pack(mlp: NeRFMLP, dev) -> k1.KernelPack:
    """The forward pack of a model on the split tile with the second
    warpgroup's part of every trunk layer (output columns [256, 512) of the
    padded layers) zeroed, weights and biases."""
    hp = k1.kernel_width(mlp.hidden_dim)
    layers = [(w.detach().clone(), b.detach().clone()) for w, b in k1._dense_layers(mlp, hp)]
    for w, b in layers[:mlp.num_layers]:
        w[hp // 2:] = 0.0
        b[hp // 2:] = 0.0
    return k1._pack_wg(layers, dev)


def _run_suite(mlp: NeRFMLP, x: dict, names=SUITE, reps: int = 5,
               plain_ms: bool = False, broken: k1.KernelPack | None = None) -> dict:
    """Every kernel of ``names`` once against its plain version, synchronised;
    with ``broken``, once more on that forward pack (``broken_miss``: how far
    beyond its gate); then its CUDA-event time (and, with ``plain_ms``, the
    plain version's)."""
    calls, plain = _suite_calls(mlp, x), _suite_plain(mlp, x)
    bad_calls = _suite_calls(mlp, x)  # K2's residuals cached apart
    out = {}
    for name in names:
        with torch.no_grad():
            got = calls[name]()
            torch.cuda.synchronize()
        want = plain[name]()
        errs = _suite_errors(got, want)
        errs["finite"] = all(bool(torch.isfinite(g.float()).all()) for g in got)
        if broken is not None:
            del got
            with torch.no_grad(), _forward_pack(broken):
                got = bad_calls[name]()
                torch.cuda.synchronize()
            errs["broken_miss"] = _bf16_gate_miss(name, _suite_errors(got, want))
        del got, want
        with torch.no_grad():
            errs["ms"] = cuda_ms(calls[name], reps=reps)
        if plain_ms:
            errs["plain_ms"] = cuda_ms(plain[name], reps=reps)
        out[name] = errs
        torch.cuda.empty_cache()
    return out


def phase_widths(card: str) -> dict:
    """Phase 26: K1 (both modes), K2, K3, K5 (with input gradients) and K6
    at hidden 16, 96 and 192 (zero-padded to 64, 128 and 256) against
    their plain versions at the same width, within the bf16 gates; the same
    kernels at 64, 128 and 256 for the padding's cost; K5's input
    gradients (and K1/K2) at L 4/2 and 16/6; every kernel at 320 (padded)
    and 512 on the split tile, K5 without input gradients, each against a
    broken pack that must miss by 10x; K4 at hidden 48, 96, 192, 320 and
    512.  B = 1,024, S = 64."""
    dev = torch.device("cuda")
    b, s = 1024, 64
    report = {"ms": {}}
    cases = [(h, 10, 4) for h in WIDTHS_PADDED + WIDTHS_NATIVE]
    cases += [(h, lx, ld) for h in (96, 256) for lx, ld in ((4, 2), (16, 6))]
    for hidden, lx, ld in cases:
        mlp = _suite_mlp(dev, hidden, seed=hidden + lx, l_xyz=lx, l_dir=ld)
        x = _suite_inputs(mlp, b, s, seed=hidden)
        names = SUITE if (lx, ld) == (10, 4) else ("k1", "k1_train", "k2", "k5_fwd", "k5_bwd")
        res = _run_suite(mlp, x, names)
        bad = [n for n, e in res.items() if not (e["finite"] and _bf16_gate_ok(n, e))]
        say("widths", hidden=hidden, kernel_width=k1.kernel_width(hidden), l_xyz=lx, l_dir=ld,
            B=b, S=s, results=res, failed=bad, card=card)
        if bad:
            raise RuntimeError(f"widths: hidden {hidden}, L {lx}/{ld}: {bad} miss the bf16 "
                               f"gates: {res}")
        report["ms"][(hidden, lx, ld)] = {n: e["ms"] for n, e in res.items()}
        del mlp, x
        torch.cuda.empty_cache()
    for hidden in WIDTHS_WIDE:
        mlp = _suite_mlp(dev, hidden, seed=hidden + 10)
        x = _suite_inputs(mlp, b, s, seed=hidden)
        reset_counts()
        res = _run_suite(mlp, x, SUITE, broken=_broken_wide_pack(mlp, dev))
        launches = counts()
        bad = [n for n, e in res.items() if not (e["finite"] and _bf16_gate_ok(n, e))]
        unseen = [n for n, e in res.items() if not e["broken_miss"] >= 10.0]
        # At 512 and 1024, K3's, K5's and K6's bounds and yardsticks at
        # these shapes (the 8x512 and 8x1024 main paths run K1, K2 and K4
        # alone): the forward's products, the dW product's and the whole
        # backward's.
        yard = {}
        if hidden in (WIDE_HIDDEN, WIDE1024_HIDDEN):
            fwd5, bwd5 = k5_bounds(mlp, b * s, False)
            fwd6, bwd6 = k6_bounds(mlp, b, s)
            yard = {"bound": {"k3": k3_bound(mlp, b, s), "k5_fwd": fwd5, "k5_bwd": bwd5,
                              "k6_fwd": fwd6, "k6_bwd": bwd6},
                    "library_ms": library_products_ms(k1.kernel_pack(mlp, dev).desc, b * s,
                                                      torch.bfloat16, dev),
                    "dw_library_ms": _dw_library_ms(mlp, dev, b * s),
                    "bwd_library_ms": _bf16_backward_library_ms(mlp, dev, b * s)}
        say("widths", hidden=hidden, kernel_width=k1.kernel_width(hidden), l_xyz=10, l_dir=4,
            B=b, S=s, k5_input_grads=_k5_input_grads(mlp), results=res, failed=bad,
            broken_pack_not_caught=unseen, launches_in_phase=launches, **yard, card=card)
        if bad or unseen:
            raise RuntimeError(f"widths: hidden {hidden}: {bad} miss the bf16 gates, or a "
                               f"broken pack passes {unseen}: {res}")
        report["ms"][(hidden, 10, 4)] = {n: e["ms"] for n, e in res.items()}
        del mlp, x
        torch.cuda.empty_cache()
    # K4 at widths it pads (48 -> 64, 96 -> 128, 192 -> 256, 320 -> 512)
    # and at 512, against its plain version on the same tables; rays of the
    # 64x64 orbit poses.  Above 256 the skip rows zeroed must miss by 10x.
    o, d = _orbit_rays(dev)
    for hidden in (48, 96, 192) + WIDTHS_WIDE:
        mlp = _suite_mlp(dev, hidden, seed=hidden)
        qp = _calibrated_qparams(mlp, dev)
        t = generate_t_vals(2.0, 6.0, (o.shape[0],), s, "stratified",
                            generator=torch.Generator().manual_seed(hidden)).to(dev).contiguous()
        got = k4.render_rays_fused_quant(qp, o, d, t)
        torch.cuda.synchronize()
        errs = _errs(got, k4.render_rays_reference_quant(qp, o, d, t))
        ms = cuda_ms(lambda: k4.render_rays_fused_quant(qp, o, d, t), reps=5)
        finite = bool(torch.isfinite(got[0]).all() and torch.isfinite(got[1]).all())
        broken_miss = None
        if hidden in WIDTHS_WIDE:
            bad_qp = _broken_qparams(qp, hidden, 4, "skip")
            broken_miss = _miss(_errs(k4.render_rays_fused_quant(bad_qp, o, d, t),
                                      k4.render_rays_reference_quant(qp, o, d, t)))
        say("widths_k4", hidden=hidden, kernel_width=k1.kernel_width(hidden, k4.K4_HIDDEN),
            B=o.shape[0], S=s, **errs, tol_max=K4_TOL_MAX, tol_mean=K4_TOL_MEAN, ms=ms,
            finite=finite, broken_skip_miss=broken_miss, card=card)
        if not finite or _miss(errs) > 1.0:
            raise RuntimeError(f"widths: K4 at hidden {hidden} misses its gates: {errs}")
        if broken_miss is not None and not broken_miss >= 10.0:
            raise RuntimeError(f"widths: K4's gates cannot see zeroed skip rows at hidden "
                               f"{hidden}: {broken_miss}")
        report["ms"][("k4", hidden)] = ms
    # The padded pack never reaches a checkpoint, a digest or a Keras export:
    # each written before and after a frame (which builds the packs) holds
    # the same bytes in every array.
    with tempfile.TemporaryDirectory() as tmp:
        cfg = dataclasses.replace(parity_config(), hidden_dim=96)
        trainer = Trainer(cfg, 2.0, 6.0, device="cuda")
        files, digests = [], []
        for i in range(2):
            if i:
                trainer.render_image(pose_spherical(30.0, -30.0, 4.0), 32, 32, 38.4)
            path = os.path.join(tmp, f"{i}.ckpt.npz")
            trainer.save(path, scene={"near": 2.0, "far": 6.0})
            keras = os.path.join(tmp, f"{i}.weights.h5")
            export_reference_weights(keras, trainer.params_tree(), cfg)
            with np.load(path) as z:
                files.append(({k: z[k].tobytes() for k in z.files}, open(keras, "rb").read()))
            digests.append(trainer.infer_digest())
        shapes = {n: tuple(p.shape) for n, p in trainer.params["fine"].named_parameters()}
    same = files[0] == files[1] and digests[0] == digests[1]
    say("widths_checkpoint", hidden=96, arrays_and_export_equal=same,
        fine_shapes=shapes, card=card)
    if not same or (shapes["feature.weight"], shapes["rgb.weight"]) != ((96, 96), (3, 48)):
        raise RuntimeError("widths: building the padded pack changed a checkpoint, a digest "
                           "or an export")
    del trainer
    torch.cuda.empty_cache()
    return report


# Phase 26b: the 8x512 main path.  The model is
# config/lego_batch_h256_tpu.json with HIDDEN_DIM 512, the widest the
# one-block kernels take (ROADMAP.md queue 2 A3).
WIDE_HIDDEN = 512
# Phase 26c: the same main path at HIDDEN_DIM 1024, mip-NeRF 360's 8x1024
# MLP (Barron et al., CVPR 2022), on the column passes of the hidden-1024
# kernels.
WIDE1024_HIDDEN = 1024
# Steps on one fixed batch: Adam's first updates at lr 5e-4 raise the loss
# at 8x512 before it falls (on an H100: 0.0853, 0.1082, 0.0871 over the
# first three), so the loss is held to fall over this many.
WIDE_STEPS = 10
# At 8x1024 the plain path's autograd over the step's 4,096 x 192 samples
# would hold more than the card's 80 GB (every layer's float32 activations),
# so the step's gradient check takes the first 1,024 rays of the batch, and
# the plain K2 (and K4) run over chunks of PLAIN_RAYS_1024 rays (the same
# function: the gradients of a batch are the sum of its chunks').
WIDE1024_CHECK_RAYS = 1024
PLAIN_RAYS_1024 = 1024
# A training step's peak at 8x1024 (the K2 workspace of one 640 MiB chunk,
# K1's residuals, the weights, their gradients and Adam's moments: 896.1
# MiB on an "NVIDIA H100 80GB HBM3, 700.00 W", against 8x512's 849.0),
# held apart from STEP_PEAK_MIB.
WIDE1024_STEP_PEAK_MIB = 1280
# Steps of the 8x1024 phase's trainer through the recompute path (K1 in
# training mode + K3), after its 10 on the default path: K3's launches on
# the phase's main path.
WIDE1024_K3_STEPS = 2


# The `wide` phases' few-sample check (``_few_samples``): K2 on the seeded
# 3 x 100 case of exp_wide_numerics at the phase's width, on this many
# draws, against the float64 yardstick.
FEW_SAMPLE_DRAWS = 8


def wide_config(hidden: int = WIDE_HIDDEN) -> NeRFConfig:
    return dataclasses.replace(load_config(CONFIG), hidden_dim=hidden)


def _plain_vjp(mlp, o, d, t, g_rgb, g_w, rays: int):
    """``render_rays_reference_vjp`` over chunks of ``rays`` rays, the
    chunks' gradients summed (the batch's own)."""
    b = o.shape[0]
    parts = [k1.render_rays_reference_vjp(mlp, o[r:r + rays], d[r:r + rays], t[r:r + rays],
                                          g_rgb[r:r + rays],
                                          None if g_w is None else g_w[r:r + rays])
             for r in range(0, b, rays)]
    return [sum(g) for g in zip(*parts)]


def _plain_k4(qp, o, d, t, rays: int):
    """``render_rays_reference_quant`` over chunks of ``rays`` rays."""
    parts = [k4.render_rays_reference_quant(qp, o[r:r + rays], d[r:r + rays], t[r:r + rays])
             for r in range(0, o.shape[0], rays)]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def _few_samples(card: str, hidden: int) -> None:
    """K2 on a few hundred samples: the seeded 3 x 100 case of
    ``exp_wide_numerics.SEEDED`` at ``hidden``, FEW_SAMPLE_DRAWS draws of
    model, rays and cotangents, each within K2_TOL_REL per leaf of the
    float64 yardstick (``exp_wide_numerics.yardstick_grads``: the kernels'
    bf16 roundings, every sum in float64); the plain path's own distance
    from it beside each draw, not gated (on so few samples single ReLU
    signs move a leaf by percents in either bf16 path)."""
    nx = exp_wide_numerics
    t0 = time.perf_counter()
    _, hid, b, seed, ray_seed, cot_seed, with_gw = next(
        c for c in nx.SEEDED if c[0] == f"h{hidden}_3x100")
    k2_rel, plain_rel = [], []
    for m in range(FEW_SAMPLE_DRAWS):
        mlp, o, d, t, g_rgb, g_w = nx.seeded(hid, seed + m, b, ray_seed + 2 * m,
                                             cot_seed + 2 * m, with_gw)
        with torch.no_grad():
            _, _, x_res, preds = k1.launch_k1(mlp, o, d, t, 10, 4, train=True)
            got = k1.launch_k2(mlp, x_res, d, t, preds, g_rgb, g_w, 10, 4)
        yard = nx.yardstick_grads(mlp, o, d, t, g_rgb, g_w)
        plain = k1.render_rays_reference_vjp(mlp, o, d, t, g_rgb, g_w)
        k2_rel.append(_leaf_errors(got, yard)[1])
        plain_rel.append(_leaf_errors(plain, yard)[1])
        if not all(bool(torch.isfinite(g).all()) for g in got):
            raise RuntimeError(f"few samples at {hidden}: non-finite K2 gradients, draw {m}")
    tag = "wide" if hidden == WIDE_HIDDEN else f"wide{hidden}"
    say(f"{tag}_few_samples", hidden=hidden, rays=b, samples=100, draws=FEW_SAMPLE_DRAWS,
        k2_rel_l2_vs_yardstick=k2_rel, plain_rel_l2_vs_yardstick=plain_rel,
        tol_rel=K2_TOL_REL, seconds=time.perf_counter() - t0, card=card)
    if max(k2_rel) > K2_TOL_REL:
        raise RuntimeError(f"{tag}: K2 on 3 x 100 samples is {max(k2_rel)} from the float64 "
                           f"yardstick (draws {k2_rel})")


def _wide_kernels(card: str, mlp: NeRFMLP, qp: dict, hidden: int = WIDE_HIDDEN) -> dict:
    """K1, K1 in training mode and K2 at B = 4096, S = 192 (the parity
    step's fine pass) and K4 at B = 16384, S = 192 (the server's chunk) on
    the 8x512 (or 8x1024: K3 too, the plain K2 and K4 over chunks of rays)
    model: each against its plain version, CUDA-event times,
    bounds and library yardsticks, with a broken dW plan and broken K4
    tables that must miss the gates by 10x; K2's device ms per kernel and
    the dW product's beside its bound and library call; K2 and K5's
    backward (N = 786,432) twice on the same inputs, the same bits (the
    clusters' bias sums in a fixed order); K1, K2 and K5 on one ray of 64
    samples, one 64-row tile: fewer than a cluster's two blocks."""
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(11)
    _, o, d = (torch.as_tensor(x, device=dev) for x in bench_batch(4096, seed=3))
    b, s = o.shape[0], 192
    t = generate_t_vals(2.0, 6.0, (b,), s, "stratified", generator=gen).to(dev).contiguous()
    g_rgb = (torch.randn((b, 3), generator=gen) * 1e-3).to(dev)
    tag = "wide" if hidden == WIDE_HIDDEN else f"wide{hidden}"
    plain_rays = b if hidden == WIDE_HIDDEN else PLAIN_RAYS_1024
    out = {}
    with torch.no_grad():
        rgb, w = k1.render_rays_fused(mlp, o, d, t)
        rgb_t, w_t, x_enc, preds = k1.launch_k1(mlp, o, d, t, 10, 4, train=True)
        got = k1.launch_k2(mlp, x_enc, d, t, preds, g_rgb, None, 10, 4)
        again = k1.launch_k2(mlp, x_enc, d, t, preds, g_rgb, None, 10, 4)
        torch.cuda.synchronize()
        k2_bits = all(torch.equal(a, c) for a, c in zip(got, again))
        del again
        rgb_p, w_p = k1.render_rays_reference(mlp, o, d, t)
        d_enc = encode_position(d, 4)[:, None, :].expand(b, s, -1).reshape(b * s, -1)
        preds_err = float((preds - mlp(x_enc.float(), d_enc)).abs().max())
        del d_enc
    errs = _errs((rgb, w), (rgb_p, w_p))
    if not (torch.equal(rgb, rgb_t) and torch.equal(w, w_t)):
        raise RuntimeError(f"{tag}: K1 in training mode changed its rgb/weights")
    if (max(errs["rgb_max"], errs["w_max"]) > TOL_MAX
            or max(errs["rgb_mean"], errs["w_mean"]) > TOL_MEAN or preds_err > PREDS_TOL):
        raise RuntimeError(f"{tag}: K1 disagrees with the plain version: {errs}, {preds_err}")
    want = _plain_vjp(mlp, o, d, t, g_rgb, None, plain_rays)
    plain_ms = cuda_ms(lambda: _plain_vjp(mlp, o, d, t, g_rgb, None, plain_rays), reps=3)
    torch.cuda.empty_cache()
    max_abs, rel = _leaf_errors(got, want)
    if rel > K2_TOL_REL or not all(bool(torch.isfinite(g).all()) for g in got):
        raise RuntimeError(f"{tag}: K2 disagrees with the plain backward: rel L2 {rel}")
    # The dW product with a tile left out must miss K2's gate by 10x.
    alloc = k1.DwBuffers.allocate
    k1.DwBuffers.allocate = staticmethod(_broken_dw_allocate(alloc))
    try:
        with torch.no_grad():
            bad = k1.launch_k2(mlp, x_enc, d, t, preds, g_rgb, None, 10, 4)
    finally:
        k1.DwBuffers.allocate = alloc
    bad_rel = _leaf_errors(bad, want)[1]
    del want, bad
    if not bad_rel >= 10 * K2_TOL_REL:
        raise RuntimeError(f"{tag}: a dW product missing a tile passes K2's gate: {bad_rel}")
    if hidden != WIDE_HIDDEN:  # K3 (the rays encoded again): K2's bits, and its time
        with torch.no_grad():
            k3_fn = lambda: k1.launch_k3(mlp, o, d, t, preds, g_rgb, None, 10, 4)  # noqa: E731
            k3_bits = all(torch.equal(a, c) for a, c in zip(k3_fn(), got))
            out["k3"] = {"bits_equal_k2": k3_bits, "ms": cuda_ms(k3_fn, reps=5),
                         "bound": k3_bound(mlp, b, s)}
        if not k3_bits:
            raise RuntimeError(f"{tag}: K3 does not give K2's bits")
    del got
    with torch.no_grad():
        out["k1"] = {"err": max(errs["rgb_max"], errs["w_max"]),
                     "ms": cuda_ms(lambda: k1.render_rays_fused(mlp, o, d, t), reps=5),
                     "plain_ms": cuda_ms(lambda: k1.render_rays_reference(mlp, o, d, t),
                                         reps=3),
                     "bound": k1_bound(mlp, b, s, train=False)}
        out["k1_train"] = {
            "err": preds_err, "plain_ms": out["k1"]["plain_ms"],
            "ms": cuda_ms(lambda: k1.launch_k1(mlp, o, d, t, 10, 4, train=True), reps=5),
            "bound": k1_bound(mlp, b, s, train=True)}
        k2 = lambda: k1.launch_k2(mlp, x_enc, d, t, preds, g_rgb, None, 10, 4)  # noqa: E731
        chunks = len(k1.chunk_plan(b, s, k1.DwBuffers.bytes_per_sample(
            k1.kernel_pack(mlp, dev), k1.kernel_pack_bwd(mlp, dev))))
        out["k2"] = {"err": max_abs, "rel_l2": rel, "plain_ms": plain_ms,
                     "ms": cuda_ms(k2, reps=5), "bound": k2_bound(mlp, b, s),
                     "device_ms": _device_ms_or_note(k2, K2_STAGES, {
                         "vjp": 1, "rows": chunks, "dw": chunks, "reduce": 1})}
        dw_ms = out["k2"]["device_ms"].get("dw")
        out["dw"] = {"device_ms": dw_ms, "launches_per_k2": chunks,
                     "ms_per_launch": None if dw_ms is None else dw_ms / chunks,
                     "bound": dw_bound(mlp, dev, b * s), "broken_rel_l2": bad_rel}
        d5 = encode_position(d, 4)[:, None, :].expand(b, s, -1).reshape(b * s, -1)
        d5 = d5.to(torch.bfloat16).contiguous()
        g5 = (torch.randn((b * s, 4), generator=gen) * 1e-2).to(dev)
        k5_runs = [k5.launch_k5_bwd(mlp, x_enc, d5, g5, False, False)[0] for _ in range(2)]
        k5_bits = all(torch.equal(a, c) for a, c in zip(*k5_runs))
        del d5, g5, k5_runs
    del x_enc, preds, rgb_p, w_p
    torch.cuda.empty_cache()
    if "k3" in out:
        out["k3"]["plain_ms"] = plain_ms
    out["k1"]["library_ms"] = out["k1_train"]["library_ms"] = library_products_ms(
        k1.kernel_pack(mlp, dev).desc, b * s, torch.bfloat16, dev)
    out["k2"]["library_ms"] = out["dw"]["library_ms"] = _dw_library_ms(mlp, dev, b * s)
    out["k2"]["bwd_library_ms"] = _bf16_backward_library_ms(mlp, dev, b * s)
    one_tile = _run_suite(mlp, _suite_inputs(mlp, 1, 64, seed=13),
                          ("k1", "k1_train", "k2", "k5_fwd", "k5_bwd"), reps=1)
    one_bad = [n for n, e in one_tile.items() if not (e["finite"] and _bf16_gate_ok(n, e))]
    _few_samples(card, hidden)
    # K4 at the server's chunk: 16384 rays of a 128x128 pose.
    o4, d4 = get_rays(128, 128, 1.2 * 128, pose_spherical(30.0, -30.0, 4.0), device=dev)
    o4, d4 = o4.reshape(-1, 3).contiguous(), d4.reshape(-1, 3).contiguous()
    t4 = generate_t_vals(2.0, 6.0, (o4.shape[0],), s, "stratified",
                         generator=gen).to(dev).contiguous()
    got4 = k4.render_rays_fused_quant(qp, o4, d4, t4)
    torch.cuda.synchronize()
    rays4 = o4.shape[0] if hidden == WIDE_HIDDEN else 4 * PLAIN_RAYS_1024
    want4 = _plain_k4(qp, o4, d4, t4, rays4)
    e4 = _errs(got4, want4)
    if _miss(e4) > 1.0:
        raise RuntimeError(f"{tag}: K4 disagrees with the plain version: {e4}")
    # Tables with the skip layer's x_enc rows zeroed must miss K4's gates by 10x.
    hq = k1.kernel_width(hidden, k4.K4_HIDDEN)
    bad4 = _errs(k4.render_rays_fused_quant(_broken_qparams(qp, hq, 4, "skip"), o4, d4, t4),
                 want4)
    del want4
    if _miss(bad4) < 10.0:
        raise RuntimeError(f"{tag}: K4 on broken tables passes its gates: {bad4}")
    out["k4"] = {"err": max(e4["rgb_max"], e4["w_max"]), "broken_miss": _miss(bad4),
                 "ms": cuda_ms(lambda: k4.render_rays_fused_quant(qp, o4, d4, t4), reps=5),
                 "plain_ms": cuda_ms(lambda: _plain_k4(qp, o4, d4, t4, rays4), reps=3),
                 "bound": k4_bound(mlp, o4.shape[0], s)}
    del got4
    torch.cuda.empty_cache()
    out["k4"]["library_ms"] = library_products_ms(
        k4.kernel_pack(qp, dev).desc, o4.shape[0] * s, torch.int8, dev)
    say(f"{tag}_kernels", hidden=hidden, k4_width=hq, B=b, S=s, B_k4=o4.shape[0],
        plain_rays_per_call=plain_rays, plain_k4_rays_per_call=rays4,
        k1_errs=errs, k2_rel_l2=rel, tol_rel=K2_TOL_REL, k4_errs=e4,
        k2_bits_repeat=k2_bits, k5_bwd_bits_repeat=k5_bits, one_tile=one_tile,
        one_tile_failed=one_bad,
        **{k: {n: v for n, v in e.items()} for k, e in out.items()}, card=card)
    if not (k2_bits and k5_bits):
        raise RuntimeError(f"{tag}: run twice, K2 ({k2_bits}) or K5's backward ({k5_bits}) "
                           f"gave other bits")
    if one_bad:
        raise RuntimeError(f"{tag}: on one tile {one_bad} miss the bf16 gates: {one_tile}")
    return out


def phase_wide(card: str, tmp: str, hidden: int = WIDE_HIDDEN) -> tuple[list[dict], dict]:
    """Phase 26b (module docstring): the 8x512 main path, then its kernels'
    numbers; phase 26c at ``hidden`` 1024 (its gradient check on the first
    WIDE1024_CHECK_RAYS rays, its steps' peak held to
    WIDE1024_STEP_PEAK_MIB, no HTTP frame).  Returns the main path's
    launches and ``_wide_kernels``."""
    tag = "wide" if hidden == WIDE_HIDDEN else f"wide{hidden}"
    cfg = wide_config(hidden)
    n_chunks = -(-200 * 200 // 16384)
    pose = pose_spherical(30.0, -30.0, 4.0)
    trainer = Trainer(cfg, 2.0, 6.0, device="cuda")
    for m in trainer.params.values():
        randomize_biases_(m, torch.Generator().manual_seed(5))
    batch = trainer.put_batch(bench_batch(cfg.batch_size))
    check_cfg, check_batch = cfg, batch
    if hidden != WIDE_HIDDEN:
        check_cfg = dataclasses.replace(cfg, batch_size=WIDE1024_CHECK_RAYS)
        check_batch = trainer.put_batch(bench_batch(WIDE1024_CHECK_RAYS))
    torch.cuda.reset_peak_memory_stats()
    losses, by_model, max_abs, _ = _grads_kernel_vs_plain(
        check_cfg, trainer, check_batch, [(check_cfg.batch_size, cfg.ns_fine)], seed=7)
    rel = max(max(v) for v in by_model.values())
    say(f"{tag}_grads_vs_plain", hidden=cfg.hidden_dim, rays=check_cfg.batch_size,
        loss_kernel=losses[0], loss_plain=losses[1], max_abs_err=max_abs, max_rel_l2=rel,
        tol_rel=STEP_TOL_REL, peak_mib=torch.cuda.max_memory_allocated() / 2**20, card=card)
    if rel > STEP_TOL_REL:
        raise RuntimeError(f"{tag}: kernel-path gradients disagree with the plain path: {rel}")
    del check_batch
    torch.cuda.empty_cache()
    run = _train_steps(trainer, batch, WIDE_STEPS, dict(ZERO, k1_train=2, k2=2))
    peak_bound = STEP_PEAK_MIB if hidden == WIDE_HIDDEN else WIDE1024_STEP_PEAK_MIB
    say(f"{tag}_train", hidden=cfg.hidden_dim, steps=WIDE_STEPS, peak_bound_mib=peak_bound,
        **run, card=card)
    if not (all(np.isfinite(x) for x in run["loss_curve"])
            and run["loss_curve"][-1] < run["loss_curve"][0]):
        raise RuntimeError(f"{tag}: the loss did not fall: {run['loss_curve']}")
    if run["peak_step_mib"] > peak_bound:
        raise RuntimeError(f"{tag}: a step peaked at {run['peak_step_mib']} MiB")
    launches = [run["launches"]]
    if hidden != WIDE_HIDDEN:  # and WIDE1024_K3_STEPS through the recompute path (K1 + K3)
        step_fn = make_train_step(cfg, 2.0, 6.0,
                                  render_pass=exp_train_paths.variant_pass(cfg, "c"))
        run_c = _train_steps(trainer, batch, WIDE1024_K3_STEPS, dict(ZERO, k1_train=2, k3=2),
                             step_fn=step_fn)
        say(f"{tag}_train_recompute", hidden=cfg.hidden_dim, steps=WIDE1024_K3_STEPS,
            peak_bound_mib=peak_bound, **run_c, card=card)
        if not all(np.isfinite(x) for x in run_c["loss_curve"]):
            raise RuntimeError(f"{tag}: non-finite losses on K3: {run_c['loss_curve']}")
        if run_c["peak_step_mib"] > peak_bound:
            raise RuntimeError(f"{tag}: a K3 step peaked at {run_c['peak_step_mib']} MiB")
        launches.append(run_c["launches"])
    reset_counts()
    t0 = time.perf_counter()
    frame = trainer.render_image(pose, 200, 200, 240.0)
    frame_s = time.perf_counter() - t0
    launches.append(counts())
    if launches[-1] != dict(ZERO, k1_fwd=2 * n_chunks):
        raise RuntimeError(f"{tag}: the float frame launched {launches[-1]}")
    rgb = frame["rgb"]
    if not (np.isfinite(rgb).all() and np.isfinite(frame["depth"]).all()) or rgb.std() == 0:
        raise RuntimeError(f"{tag}: a non-finite or constant float frame")
    trainer.quantize_for_inference(*trainer.pose_rays(pose, 200, 200, 240.0))
    reset_counts()
    qframe = trainer.render_image(pose, 200, 200, 240.0, quant=True)
    launches.append(counts())
    psnr = frame_psnr(rgb, qframe["rgb"])
    say(f"{tag}_frames", size=200, float_s=frame_s, float_launches=launches[-2],
        int8_launches=launches[-1], int8_psnr_vs_float_db=psnr, gate_db=QUANT_GATE_DB,
        card=card)
    if launches[-1] != dict(ZERO, k4=2 * n_chunks):
        raise RuntimeError(f"{tag}: the int8 frame launched {launches[-1]}")
    if not (np.isfinite(qframe["rgb"]).all() and psnr >= QUANT_GATE_DB):
        raise RuntimeError(f"{tag}: the int8 frame reads {psnr} dB against the float frame")
    mlp, qp = trainer.params["fine"], trainer.qparams["fine"]
    if hidden != WIDE_HIDDEN:
        del batch
        torch.cuda.empty_cache()
        kernels = _wide_kernels(card, mlp, qp, hidden)
        del trainer
        torch.cuda.empty_cache()
        return launches, kernels
    ckpt = os.path.join(tmp, "wide.ckpt.npz")
    trainer.save(ckpt, scene={"near": 2.0, "far": 6.0})
    service = RenderService(cfg, ckpt, device="cuda")
    server = serve(service, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        reset_counts()
        png, seconds = _get(f"http://127.0.0.1:{server.server_address[1]}/render?theta=30"
                            f"&phi=-30&radius=4&width=200&height=200&chunk=16384&map=rgb")
        launches.append(counts())
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    img = decode_png(png)
    say("wide_serve", size=200, latency_s=seconds, launches=launches[-1],
        shape=list(img.shape), std=float(img.std()), card=card)
    if img.shape != (200, 200, 3) or img.std() == 0:
        raise RuntimeError(f"wide: the served frame is {img.shape}, std {img.std()}")
    if launches[-1] != dict(ZERO, k1_fwd=2 * n_chunks):
        raise RuntimeError(f"wide: the served frame launched {launches[-1]}")
    del service, batch
    torch.cuda.empty_cache()
    kernels = _wide_kernels(card, mlp, qp)
    del trainer
    torch.cuda.empty_cache()
    return launches, kernels


class _F64SumDense(torch.autograd.Function):
    """The plain float32 dense layer, ``x @ w.T + b`` forward and ``g @ w``
    for the input's gradient, with its weight and bias gradients summed
    over the batch in float64."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        return x @ w.T + b

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1]).double()
        gw = (g2.T @ x.reshape(-1, x.shape[-1]).double()).float()
        return g @ w, gw, g2.sum(0).float()


def _volume_render_f64(preds, t_vals):
    """``ops/volume.volume_render``'s compositing in float64, its outputs
    rounded to float32 (depth is not used by the plain kernels)."""
    p, t = preds.double(), t_vals.double()
    rgb, sigma = torch.sigmoid(p[..., :3]), torch.relu(p[..., 3])
    delta = torch.cat([torch.diff(t, dim=-1), torch.full_like(t[..., :1], 1e10)], dim=-1)
    alpha = 1.0 - torch.exp(-sigma * delta)
    trans = torch.cumprod(1.0 - alpha + 1e-10, dim=-1)
    trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], dim=-1)
    weights = alpha * trans
    return (weights[..., None] * rgb).sum(dim=-2).float(), None, weights.float()


@contextlib.contextmanager
def _f64_yardstick():
    """The plain float32 MLP (``models/mlp._dense``) with its parameter
    gradients summed in float64 (:class:`_F64SumDense`), and the plain
    kernels' compositing in float64 (:func:`_volume_render_f64`)."""
    from nerf_keras_tpu_torch.models import mlp as mlp_module

    orig_dense, orig_vr = mlp_module._dense, k1.volume_render

    def dense(x, layer, dtype):
        if dtype != torch.float32:
            raise ValueError("the float64 sums are a yardstick of float32 MLPs")
        return _F64SumDense.apply(x.float(), layer.weight, layer.bias)

    mlp_module._dense, k1.volume_render = dense, _volume_render_f64
    try:
        yield
    finally:
        mlp_module._dense, k1.volume_render = orig_dense, orig_vr


def _f32_bounds(mlp: NeRFMLP, b: int, s: int, peak: float) -> dict:
    """The least time of each f32 kernel of the suite at (B, S): its
    products at the card's f32 FFMA peak, or its bytes (each input read
    once, each output written once; f32 weights and encodings) at the
    memory rate."""
    n = b * s
    fwd, dx = 2.0 * mlp_macs(mlp) * n, 2.0 * mlp_dx_macs(mlp, False) * n
    dx_ig = 2.0 * mlp_dx_macs(mlp, True) * n
    pb = param_bytes(mlp)
    enc = (mlp.xyz_dim + mlp.dir_dim) * 4
    rays = b * (24 + 12)
    return {
        "k1": bound(fwd, rays + n * 8 + pb, peak),
        "k1_train": bound(fwd, rays + n * (8 + mlp.xyz_dim * 4 + 16) + pb, peak),
        "k2": bound(2 * fwd + dx, n * (mlp.xyz_dim * 4 + 16 + 8) + b * 24 + 3 * pb, peak),
        "k3": bound(2 * fwd + dx, n * (16 + 8) + b * 36 + 3 * pb, peak),
        "k6_fwd": bound(fwd, n * (enc + 8) + b * 12 + pb, peak),
        "k6_bwd": bound(2 * fwd + dx, n * (enc + 20) + b * 12 + 3 * pb, peak),
        "k5_fwd": bound(fwd, n * (enc + 16) + pb, peak),
        "k5_bwd": bound(2 * fwd + dx_ig, n * (2 * enc + 16) + 3 * pb, peak),
    }


def _f32_library_ms(mlp: NeRFMLP, dev, m: int) -> dict:
    """Yardsticks, never called by the port: the forward's products as one
    f32 ``torch.matmul`` per padded layer at M = ``m`` rows (TF32 off); the
    dW product as one f32 ``torch.matmul`` of A^T D per layer; the whole
    backward's products (the recomputed forward A W, dX = D W^T and dW =
    A^T D) as three per layer, at the f32 pack's widths."""
    fwd = library_products_ms(k1.kernel_pack(mlp, dev).desc, m, torch.float32, dev)
    pack = fused_f32.kernel_pack_f32(mlp, dev)
    layers = [(torch.randn((m, int(k)), device=dev), torch.randn((m, int(n)), device=dev),
               torch.randn((int(k), int(n)), device=dev)) for k, n in pack.desc[:, :2]]

    def backward():
        for a, d, w in layers:
            torch.matmul(a, w)
            torch.matmul(d, w.t())
            torch.matmul(a.t(), d)

    dw = cuda_ms(lambda: [torch.matmul(a.t(), d) for a, d, _ in layers], reps=5)
    bwd = cuda_ms(backward, reps=3)
    del layers
    torch.cuda.empty_cache()
    return {"fwd": fwd, "dw": dw, "bwd": bwd}


# The f32 backward's kernels, by the names torch.profiler reports.
F32_BWD_FAMILIES = {"vjp": ("composite_vjp_kernel",), "rows": ("f32_rows_kernel",),
                    "dw": ("f32_dw_kernel",), "reduce": ("mlp_reduce_kernel",)}


def _device_ms_or_note(fn, families: dict, launches: dict) -> dict:
    """``device_ms_by_kernel`` over up to 8 profiler windows; where the
    profiler recorded no device work in any (it did so once late in a
    whole smoke run, where a fresh process records it), the reason in
    place of the times: a measurement, not a gate."""
    try:
        return device_ms_by_kernel(fn, families, tries=8, launches=launches)
    except RuntimeError as e:
        return {"not_measured": str(e)}


def _f32_ptxas() -> list[str]:
    """``fused_render_f32.cu``'s lines of the ``-Xptxas -v`` report: each
    kernel's name, then its stack, spills, registers and static shared
    memory.  From ``phase_build``'s log, or, where the library was built
    before this process, from compiling the source to a cubin again."""
    log = _build.build_log
    if "== fused_render_f32.cu" not in log:
        flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
        with tempfile.TemporaryDirectory() as tmp:
            proc = subprocess.run([_build._nvcc(), *flags, "-cubin", "-I", str(_build.CSRC), "-o",
                                   os.path.join(tmp, "f32.cubin"),
                                   str(_build.CSRC / "fused_render_f32.cu")],
                                  capture_output=True, text=True, check=True)
        log = "== fused_render_f32.cu\n" + proc.stdout + proc.stderr
    section = log.split("== fused_render_f32.cu")[1].split("\n== ")[0]
    return [line.strip() for line in section.splitlines()
            if "Compiling entry" in line or "Used" in line or "spill" in line]


def _f32_backward(mlp: NeRFMLP, x: dict) -> dict:
    """The f32 backward alone in its four modes on ``x``: K3 and K6 timed
    without their forwards (the suite times K2 and K5's backwards alone
    already), the device ms of each mode's kernels (``F32_BWD_FAMILIES``,
    from a profiler window that recorded every launch: the launches it
    saw beside them), and two launches of K2 and of K5 compared bit for
    bit."""
    o, d, t, g_rgb, g_w = x["o"], x["d"], x["t"], x["g_rgb"], x["g_w"]
    lx, ld = mlp.l_xyz, mlp.l_dir
    b, s = t.shape
    calls = _suite_calls(mlp, x)
    per = fused_f32.bytes_per_sample(fused_f32.kernel_pack_f32(mlp, t.device))
    chunks = {name: len(k1.chunk_plan(b * s, 1, per) if name == "k5_bwd" else
                        k1.chunk_plan(b, s, per))
              for name in ("k2", "k3", "k6_bwd", "k5_bwd")}
    out = {"ms": {}, "device_ms": {}, "repeat_identical": {}}
    with torch.no_grad():
        preds3 = k1.launch_k1(mlp, o, d, t, lx, ld, train=True, emit_xenc=False)[3]
        preds6 = k1.launch_k6_fwd(mlp, x["x_enc"], x["d_enc"], t, train=True)[2]
        alone = {
            "k2": calls["k2"],
            "k3": lambda: k1.launch_k3(mlp, o, d, t, preds3, g_rgb, g_w, lx, ld),
            "k6_bwd": lambda: k1.launch_k6_bwd(mlp, x["x_enc"], x["d_enc"], t, preds6, g_rgb),
            "k5_bwd": calls["k5_bwd"],
        }
        for name in ("k2", "k5_bwd"):
            first, second = alone[name](), alone[name]()
            out["repeat_identical"][name] = all(torch.equal(u, v) for u, v in zip(first, second))
            del first, second
        for name, fn in alone.items():
            # A rows and a dW launch a chunk, one reduce, one VJP but K5's.
            want = {"vjp": int(name != "k5_bwd"), "rows": chunks[name], "dw": chunks[name],
                    "reduce": 1}
            out["device_ms"][name] = _device_ms_or_note(fn, F32_BWD_FAMILIES, want)
        for name in ("k3", "k6_bwd"):
            out["ms"][name] = cuda_ms(alone[name], reps=3)
    del calls, alone, preds3, preds6
    torch.cuda.empty_cache()
    return out


# The f32 forward's kernels, by the names torch.profiler reports.
F32_FWD_FAMILIES = {"fwd": ("f32_fwd_kernel",), "composite": ("f32_composite_kernel",)}



def _f32_forward(mlp: NeRFMLP, x: dict) -> dict:
    """The f32 forward in its four forms on ``x`` (K1 and its training
    form, K6's and K5's forwards): the device ms of ``f32_fwd_kernel`` and
    of ``f32_composite_kernel`` apart, from a profiler window that recorded
    one launch of each; two launches compared bit for bit; K1's f32 x_enc
    residual against the plain encode of o + d * t (``x["x_enc"]``), bit
    for bit."""
    calls = _suite_calls(mlp, x)
    out = {"device_ms": {}, "repeat_identical": {}}
    with torch.no_grad():
        for name in ("k1", "k1_train", "k6_fwd", "k5_fwd"):
            first, second = calls[name](), calls[name]()
            out["repeat_identical"][name] = all(torch.equal(u, v) for u, v in zip(first, second))
            del first, second
            want = {"fwd": 1, "composite": int(name != "k5_fwd")}
            out["device_ms"][name] = _device_ms_or_note(calls[name], F32_FWD_FAMILIES, want)
        b, s = x["t"].shape
        x_res = k1.launch_k1(mlp, x["o"], x["d"], x["t"], mlp.l_xyz, mlp.l_dir, train=True)[2]
        out["x_enc_equal"] = torch.equal(x_res, x["x_enc"].reshape(b * s, -1))
    del calls
    torch.cuda.empty_cache()
    return out


def _ptxas_kernel(lines: list[str], kernel: str) -> dict:
    """``kernel``'s registers and spill bytes from ``-Xptxas -v`` lines
    (:func:`_f32_ptxas`)."""
    entry = [i for i, ln in enumerate(lines) if "Compiling entry" in ln and kernel in ln]
    if not entry:
        raise RuntimeError(f"no -Xptxas -v line of {kernel}")
    out = {}
    for ln in lines[entry[0] + 1:]:
        if "Compiling entry" in ln:
            break
        if "spill" in ln:
            out["spill_bytes"] = sum(int(v) for v in re.findall(r"(\d+) bytes spill", ln))
        if "Used" in ln:
            out["registers"] = int(re.search(r"Used (\d+) registers", ln).group(1))
    return out


def _f32_config(base, **changes):
    return dataclasses.replace(base, compute_dtype="float32", **changes).validate()


def _f32_steps(card: str, name: str, trainer, batch, steps: int, per_step: dict,
               step_fn=None) -> dict:
    run = _train_steps(trainer, batch, steps, per_step, step_fn=step_fn)
    say("f32_train", path=name, steps=steps, **run, card=card)
    if not all(np.isfinite(x) for x in run["loss_curve"]):
        raise RuntimeError(f"f32 {name}: non-finite losses {run['loss_curve']}")
    return run["launches"]


def phase_f32(card: str, tmp: str) -> tuple[list[dict], dict]:
    """Phase 27: COMPUTE_DTYPE=float32 at ``lego_batch_h256_tpu``'s full
    widths (8x256, skip 4, L 10/4): (a) each f32 kernel against its plain
    version (TF32 off) with its parameter-gradient sums and compositing in
    float64 (``_f64_yardstick``) at B = 4,096, S = 192 within F32_TOL_REL,
    its distance to the plain f32 version beside it, while the bf16 kernels on a bf16 copy of
    the same weights and inputs miss the gate by 10x or more; times, bounds (the card's f32 FFMA peak) and the f32
    library yardsticks; (b) parity steps through K1+K2 (one step's
    gradients against the plain path with the same draws), K1+K3, K6 and
    K5 (STOP_PDF_GRADIENT=false), and proposal-recipe steps, each with
    exact f32 launch counts and no bf16 launch; (c) a 200x200 frame from
    ``Trainer.render_image``; (d) one ``GET /render`` from the server on an
    f32 checkpoint; (e) the verify recipe's tiny f32 config through
    ``cli.train_synthetic``.  With (a) the forward in its four forms
    (``_f32_forward``: the device ms of ``f32_fwd_kernel`` and of the
    compositing apart, two launches bit for bit, K1's x_enc residual equal
    to the plain encode bit for bit, ``f32_fwd_kernel``'s registers with no
    spill), the backward alone in all four modes (``_f32_backward``: K3's
    and K6's times without their forwards, which stay beside them as
    ``ms_with_forward``; device ms by kernel; K2 and K5 launched twice, bit
    for bit), the f32 source's ``-Xptxas -v`` lines and the whole
    backward's library yardstick.  Returns the main paths' launches and the
    kernels' figures."""
    dev = torch.device("cuda")
    b, s = 4096, 192
    peak = peak_f32()
    mlp = _suite_mlp(dev, 256, seed=27, dtype=torch.float32)
    x = _suite_inputs(mlp, b, s, seed=27)
    res = _run_suite(mlp, x, reps=3, plain_ms=True)  # errors vs the plain f32 version
    bf = copy.deepcopy(mlp)
    bf.compute_dtype = torch.bfloat16
    xb = dict(x, x_enc=x["x_enc"].to(torch.bfloat16), d_enc=x["d_enc"].to(torch.bfloat16))
    calls, calls_bf, plain = _suite_calls(mlp, x), _suite_calls(bf, xb), _suite_plain(mlp, x)
    for name in SUITE:
        e = res[name]
        e["rel_l2_vs_plain_f32"], e["each_vs_plain_f32"] = e.pop("rel_l2"), e.pop("rel_l2_each")
        with _f64_yardstick():
            want = plain[name]()
        with torch.no_grad():
            got = calls[name]()
            got_bf = calls_bf[name]()
        errs = _suite_errors(got, want)
        e.update(max_abs=errs["max_abs"], rel_l2=errs["rel_l2"], rel_l2_each=errs["rel_l2_each"],
                 bf16_rel_l2=_suite_errors(got_bf, want)["rel_l2"])
        del got, got_bf, want
        torch.cuda.empty_cache()
    del bf, xb, calls, calls_bf, plain
    # K3's and K6's suite calls run their forwards too: their times become
    # the backward's alone, the forward-plus-backward kept beside them.
    forward = _f32_forward(mlp, x)
    ptxas = _f32_ptxas()
    fwd_ptxas = _ptxas_kernel(ptxas, "f32_fwd_kernel")
    say("f32_forward", B=b, S=s, device_ms=forward["device_ms"],
        repeat_identical=forward["repeat_identical"], x_enc_equal=forward["x_enc_equal"],
        ptxas=fwd_ptxas, card=card)
    if (not forward["x_enc_equal"] or not all(forward["repeat_identical"].values())
            or fwd_ptxas.get("spill_bytes", 1)):
        raise RuntimeError(f"f32 forward: x_enc residual equal {forward['x_enc_equal']}, "
                           f"repeats {forward['repeat_identical']}, ptxas {fwd_ptxas}")
    backward = _f32_backward(mlp, x)
    for name in ("k3", "k6_bwd"):
        res[name]["ms_with_forward"] = res[name]["ms"]
        res[name]["ms"] = backward["ms"][name]
    bounds = _f32_bounds(mlp, b, s, peak)
    library = _f32_library_ms(mlp, dev, b * s)
    for name, e in res.items():
        e.update(bound_ms=bounds[name][0], bound_by=bounds[name][1])
    say("f32_kernels", B=b, S=s, peak_f32_flops=peak, tol_rel=F32_TOL_REL, results=res,
        library_ms=library, card=card)
    say("f32_backward", B=b, S=s, device_ms=backward["device_ms"],
        repeat_identical=backward["repeat_identical"], ptxas=ptxas, card=card)
    bad = [n for n, e in res.items() if not (e["finite"] and e["rel_l2"] <= F32_TOL_REL)]
    blind = [n for n, e in res.items() if e["bf16_rel_l2"] < 10 * F32_TOL_REL]
    if bad or blind:
        raise RuntimeError(f"f32: {bad} miss the f32 gate; the gate cannot tell bf16 "
                           f"products from f32 for {blind}: {res}")
    differ = [n for n, same in backward["repeat_identical"].items() if not same]
    if differ:
        raise RuntimeError(f"f32: two launches of {differ} gave different bits")
    del mlp, x
    torch.cuda.empty_cache()

    runs = []
    # (b) The parity step (64 + 128 samples) through each training path.
    cfg = _f32_config(parity_config())
    trainer = exp_train_paths.make_trainer(cfg)
    batch = trainer.put_batch(bench_batch(cfg.batch_size))
    losses, by_model, max_abs, _ = _grads_kernel_vs_plain(
        cfg, trainer, batch, [(cfg.batch_size, cfg.ns_fine)], seed=4)
    rel = max(max(v) for v in by_model.values())
    say("f32_parity_grads_vs_plain", loss_kernel=losses[0], loss_plain=losses[1],
        max_abs_err=max_abs, max_rel_l2=rel, tol_rel=F32_STEP_TOL_REL, card=card)
    if rel > F32_STEP_TOL_REL:
        raise RuntimeError(f"f32 parity step: kernel-path gradients disagree: {rel}")
    per_step = {"b": dict(ZERO, k1_train_f32=2, k2_f32=2), "c": dict(ZERO, k1_train_f32=2,
                                                                      k3_f32=2),
                "a": dict(ZERO, k6_fwd_f32=2, k6_bwd_f32=2)}
    for n, want in per_step.items():
        step_fn = (None if n == "b" else
                   make_train_step(cfg, 2.0, 6.0, render_pass=exp_train_paths.variant_pass(cfg, n)))
        runs.append(_f32_steps(card, f"parity-{n}", trainer, batch, 3, want, step_fn))
    ev, after = _eval_and_frame(trainer, batch, "f32 parity")
    n_chunks = -(-200 * 200 // (cfg.test_batch_size or cfg.batch_size))
    say("f32_frame", eval=ev, launches=after, card=card)
    if after["k1_fwd_f32"] == 0 or any(v for k, v in after.items() if k != "k1_fwd_f32"):
        raise RuntimeError(f"f32 eval and frame launched {after} ({n_chunks} chunks)")
    runs.append(after)
    ckpt = os.path.join(tmp, "f32.ckpt.npz")
    trainer.save(ckpt, scene={"near": 2.0, "far": 6.0})
    del trainer, batch
    torch.cuda.empty_cache()
    cfg5 = _f32_config(parity_config(stop_pdf_gradient=False))
    trainer = exp_train_paths.make_trainer(cfg5)
    batch = trainer.put_batch(bench_batch(cfg5.batch_size))
    runs.append(_f32_steps(card, "parity-k5", trainer, batch, 3,
                           dict(ZERO, k5_fwd_f32=2, k5_bwd_f32=2)))
    del trainer, batch
    torch.cuda.empty_cache()
    cfgp = _f32_config(bench_config())
    trainer = Trainer(cfgp, 2.0, 6.0, device="cuda")
    batch = trainer.put_batch(bench_batch(cfgp.batch_size))
    runs.append(_f32_steps(card, "proposal", trainer, batch, 3,
                           dict(ZERO, k1_train_f32=1, k2_f32=1)))
    del trainer, batch
    torch.cuda.empty_cache()

    # (d) The server on the f32 checkpoint.
    cfg_file = _config_file(os.path.join(tmp, "f32.json"), COMPUTE_DTYPE="float32")
    service = RenderService(load_config(cfg_file), ckpt, device="cuda")
    server = serve(service, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        reset_counts()
        png, seconds = _get(f"http://127.0.0.1:{server.server_address[1]}/render?theta=30"
                            f"&phi=-30&radius=4&width=200&height=200&chunk=16384&map=rgb")
        served = counts()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    img = decode_png(png)
    say("f32_serve", latency_s=seconds, shape=list(img.shape), std=float(img.std()),
        launches=served, card=card)
    if img.shape != (200, 200, 3) or img.std() == 0 or served != dict(ZERO, k1_fwd_f32=2 * 3):
        raise RuntimeError(f"f32 /render: shape {img.shape}, launches {served}")
    runs.append(served)
    del service
    torch.cuda.empty_cache()

    # (e) The verify recipe's tiny f32 config through the training CLI.
    tiny = os.path.join(tmp, "tiny_f32.json")
    with open(tiny, "w") as f:
        json.dump({"BATCH_SIZE": 128, "NS_COARSE": 8, "NS_FINE": 16, "HEIGHT": 20,
                   "WIDTH": 20, "L_XYZ": 10, "L_DIR": 4, "NUM_LAYERS": 4, "HIDDEN_DIM": 64,
                   "SKIP_LAYER": 4, "EPOCHS": 3, "LEARNING_RATE": 0.002,
                   "BATCH_NORM": False, "WITH_GCS": False, "COMPUTE_DTYPE": "float32",
                   "EVAL_EVERY": 2}, f)
    _, out, launches = _cli(train_synthetic.main, ["--config", tiny, "--run-dir",
                                                   os.path.join(tmp, "tiny_f32")])
    losses = [float(m) for m in re.findall(r"^epoch \d+/\d+ loss=(\S+)", out, re.M)]
    say("f32_train_cli", launches=launches, losses=losses, card=card)
    bf16 = {k: v for k, v in _clean(launches).items() if not k.endswith("_f32") and v}
    if bf16 or not launches["k1_train_f32"] or launches["k2_f32"] != launches["k1_train_f32"]:
        raise RuntimeError(f"f32 train_cli: launches {launches}")
    if len(losses) != 3 or not losses[-1] < losses[0]:
        raise RuntimeError(f"f32 train_cli: losses {losses}")
    runs.append(_clean(launches))
    return runs, {"results": res, "library": library, "card": card}


def _sum(runs: list[dict], key: str) -> int:
    return sum(r.get(key, 0) for r in runs)


def main() -> None:
    card = phase_card()
    phase_build()
    k1r = phase_kernel(card)
    k2r = phase_k2(card)
    torch.cuda.empty_cache()
    k2c = phase_k2_chunks(card)
    torch.cuda.empty_cache()
    k5r = phase_k5(card)
    torch.cuda.empty_cache()
    k5c = phase_k5_chunks(card)
    torch.cuda.empty_cache()
    k4r = phase_k4(card)
    torch.cuda.empty_cache()
    k3r = phase_k3(card)
    k6r = phase_k6(card)
    k7r = phase_k7(card)
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        runs.append(phase_serve(card, tmp))
        runs.append(phase_serve_int8(card, tmp))
        torch.cuda.empty_cache()
        train_runs, trainer = phase_train(card)
        runs += train_runs
        runs.append(phase_proposal_int8(card, trainer))
        del trainer
        torch.cuda.empty_cache()
        parity, ckpt = phase_parity(card, True, tmp)
        runs += parity
        torch.cuda.empty_cache()
        runs += phase_parity(card, False, tmp)[0]
        torch.cuda.empty_cache()
        runs.append(phase_full_render(card, ckpt))
        torch.cuda.empty_cache()
        runs += phase_paths(card)
        runs.append(phase_pdf_frame(card, ckpt))
        torch.cuda.empty_cache()
        cli_runs, run_dir = phase_train_cli(card, tmp)
        runs += cli_runs
        torch.cuda.empty_cache()
        phase_visualization(card, tmp, run_dir)
        runs += phase_infer_cli(card, tmp, run_dir)
        torch.cuda.empty_cache()
        runs += phase_fern_cli(card, tmp)
        torch.cuda.empty_cache()
        runs += phase_fern_jpeg(card, tmp)
        torch.cuda.empty_cache()
        runs += phase_dp(card)
        torch.cuda.empty_cache()
        runs += phase_dp_infer(card, tmp)
        torch.cuda.empty_cache()
        runs += phase_tp(card, tmp)
        torch.cuda.empty_cache()
        uf_runs, uf = phase_union_free(card, tmp)
        runs += uf_runs
        torch.cuda.empty_cache()
        runs += phase_keras(card, tmp, {
            "lego_batch_h256_tpu": (CONFIG, run_dir),
            "lego_batch_debug": (os.path.join(os.path.dirname(CONFIG), "lego_batch_debug.json"),
                                 os.path.join(tmp, "cli_bn"))})
        torch.cuda.empty_cache()
        wr = phase_widths(card)
        torch.cuda.empty_cache()
        wide_runs, wide = phase_wide(card, tmp)
        torch.cuda.empty_cache()
        wide1024_runs, wide1024 = phase_wide(card, tmp, WIDE1024_HIDDEN)
        torch.cuda.empty_cache()
        f32_runs, f32r = phase_f32(card, tmp)
        runs += f32_runs
        torch.cuda.empty_cache()
        runs += phase_captures(card, tmp)
    # Library yardsticks measured once and shared where two kernels do the
    # same products at the same M: K1's per-layer bf16 matmul at M = 4096 x
    # 192 is K5's forward at N = 786,432 and K6's forward at S=192; K2's dW
    # at B=4096, S=160 is K3's; K5's dW at N = 786,432 is K6's backward.
    kernels = [
        kernel_entry("K1 fused_render_fwd", "K1", _sum(runs, "k1_fwd"), k1r["max_abs_err"],
                     k1r["ms_s192"], k1r["plain_ms_s192"], k1r["bound_s192"],
                     k1r["library_ms_s192"]),
        kernel_entry("K1-train fused_render_fwd (residuals)", "K1", _sum(runs, "k1_train"),
                     k2r["k1_train_err"], k2r["k1_train_ms"], k2r["k1_train_plain_ms"],
                     k2r["k1_train_bound"], k2r["k1_train_library_ms"]),
        kernel_entry("K2 fused_render_bwd", "K2", _sum(runs, "k2"), k2r["max_abs_err"],
                     k2r["ms"], k2r["plain_ms"], k2r["bound"], k2c["library_ms"]),
        kernel_entry("K5-fwd fused_mlp_fwd", "K5f", _sum(runs, "k5_fwd"),
                     k5r["fwd_max_abs_err"], k5r["fwd_ms"], k5r["fwd_plain_ms"],
                     k5r["fwd_bound"], k1r["library_ms_s192"]),
        kernel_entry("K5-bwd fused_render_bwd (k5_rows)", "K5b", _sum(runs, "k5_bwd"),
                     k5r["bwd_max_abs_err"], k5r["bwd_ms"], k5r["bwd_plain_ms"],
                     k5r["bwd_bound"], k5c["library_ms"]),
        kernel_entry("K4 quant_render_fwd", "K4", _sum(runs, "k4"), k4r["max_abs_err"],
                     k4r["ms_b16384_s192"], k4r["plain_ms_b16384_s192"],
                     k4r["bound_b16384_s192"], k4r["library_ms_b16384_s192"]),
        kernel_entry("K3 fused_render_bwd (recompute)", "K3", _sum(runs, "k3"),
                     k3r["max_abs_err"], k3r["ms"], k3r["plain_ms"], k3r["bound"],
                     k2c["library_ms"]),
        kernel_entry("K6-fwd fused_render_fwd (encodings in)", "K6f", _sum(runs, "k6_fwd"),
                     k6r["fwd_max_abs_err"], k6r["fwd_ms"], k6r["fwd_plain_ms"],
                     k6r["fwd_bound"], k1r["library_ms_s192"]),
        kernel_entry("K6-bwd fused_render_bwd (encodings in)", "K6b", _sum(runs, "k6_bwd"),
                     k6r["bwd_max_abs_err"], k6r["bwd_ms"], k6r["bwd_plain_ms"],
                     k6r["bwd_bound"], k5c["library_ms"]),
        kernel_entry("K7 pdf_union", "K7", _sum(runs, "k7"), k7r["max_abs_err"], k7r["ms"],
                     k7r["plain_ms"], k7r["bound"]),
    ]
    # The union-free layout's shapes (phase 23), each with its launches at
    # that S on phase 23's main paths.
    n = uf["launches"]
    for s in (128, 32):
        r = uf[s]
        if s == 128:
            kernels.append(kernel_entry(
                "K1 fused_render_fwd (union-free, S=128)", "K1", n.get(("k1_fwd", s), 0),
                r["fwd_err"], r["fwd_ms"], r["fwd_plain_ms"], r["fwd_bound"], r["library_ms"]))
        kernels += [
            kernel_entry(f"K1-train fused_render_fwd (union-free, S={s})", "K1",
                         n.get(("k1_train", s), 0), r["train_err"], r["train_ms"],
                         r["train_plain_ms"], r["train_bound"], r["library_ms"]),
            kernel_entry(f"K2 fused_render_bwd (union-free, S={s})", "K2", n.get(("k2", s), 0),
                         r["k2_err"], r["k2_ms"], r["k2_plain_ms"], r["k2_bound"],
                         r["dw_library_ms"]),
        ]
    r = uf["k4"]
    kernels.append(kernel_entry("K4 quant_render_fwd (union-free, S=128)", "K4",
                                n.get(("k4", 128), 0), r["err"], r["ms"], r["plain_ms"],
                                r["bound"], r["library_ms"]))
    # The float32 kernels (phase 27), each with its launches on phase 27's
    # main paths; the products' and the dW product's f32 yardsticks.
    res, lib = f32r["results"], f32r["library"]
    for name, key, count, library in (
            ("K1-f32 f32_fwd_kernel", "K1-f32", "k1_fwd_f32", lib["fwd"]),
            ("K1-train-f32 f32_fwd_kernel (f32 residual)", "K1-f32", "k1_train_f32", lib["fwd"]),
            ("K2-f32 f32_rows_kernel", "K2-f32", "k2_f32", lib["dw"]),
            ("K3-f32 f32_rows_kernel (recompute)", "K3-f32", "k3_f32", lib["dw"]),
            ("K5-fwd-f32 f32_fwd_kernel (no compositing)", "K5f-f32", "k5_fwd_f32", lib["fwd"]),
            ("K5-bwd-f32 f32_rows_kernel (input gradients)", "K5b-f32", "k5_bwd_f32", lib["dw"]),
            ("K6-fwd-f32 f32_fwd_kernel (encodings in)", "K6f-f32", "k6_fwd_f32", lib["fwd"]),
            ("K6-bwd-f32 f32_rows_kernel (encodings in)", "K6b-f32", "k6_bwd_f32", lib["dw"])):
        e = res[{"K1-f32": "k1_train" if "train" in name else "k1", "K2-f32": "k2",
                 "K3-f32": "k3", "K5f-f32": "k5_fwd", "K5b-f32": "k5_bwd",
                 "K6f-f32": "k6_fwd", "K6b-f32": "k6_bwd"}[key]]
        kernels.append(kernel_entry(name, key, _sum(runs, count), e["max_abs"], e["ms"],
                                    e["plain_ms"], (e["bound_ms"], e["bound_by"]), library))
    # The 8x512 and 8x1024 kernels (phases 26b and 26c), each with its
    # launches on its phase's main path.
    for width, res, runs_w in ((WIDE_HIDDEN, wide, wide_runs),
                               (WIDE1024_HIDDEN, wide1024, wide1024_runs)):
        for name, key, count in (("K1 fused_render_fwd", "K1", "k1"),
                                 ("K1-train fused_render_fwd (residuals)", "K1", "k1_train"),
                                 ("K2 fused_render_bwd", "K2", "k2"),
                                 ("K4 quant_render_fwd", "K4", "k4")):
            e = res[count]
            label = (name[:-1] + f", 8x{width})") if name.endswith(")") else f"{name} (8x{width})"
            key = f"K2-{width}" if key == "K2" else key
            kernels.append(kernel_entry(label, key,
                                        _sum(runs_w, "k1_fwd" if count == "k1" else count),
                                        e["err"], e["ms"], e["plain_ms"], e["bound"],
                                        e["library_ms"]))
    # K3 at 8x1024 gives K2's bits on K2's inputs: K2's error, plain
    # version and library call.
    e, e2 = wide1024["k3"], wide1024["k2"]
    kernels.append(kernel_entry(f"K3 fused_render_bwd (recompute, 8x{WIDE1024_HIDDEN})",
                                f"K3-{WIDE1024_HIDDEN}", _sum(wide1024_runs, "k3"), e2["err"],
                                e["ms"], e["plain_ms"], e["bound"], e2["library_ms"]))
    say("widths_ms", ms={str(k): v for k, v in wr["ms"].items()}, card=card)
    for entry in kernels:
        if entry["launches"] == 0:
            raise RuntimeError(f"{entry['name']} was never launched on the main path")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.exit(0)
