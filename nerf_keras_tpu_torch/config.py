"""Config system: the port's own copy of ``nerf_keras_tpu/config.py``.

The port imports nothing of the JAX package, so it keeps this copy of
the JAX package's config schema: every field, default and validation
rule, the UPPERCASE JSON key map and the JSON helpers, unchanged.  It is
stdlib-only.  ``tests/test_torch_config.py`` holds the two copies
together (fields, defaults, every shipped ``config/*.json``, and the
errors of invalid combinations).

Mirrors the reference's flat-JSON schema (reference: config/*.json, loaded at
train_lego.py:30-50 into module globals) but parses into a frozen dataclass
with validation, defaults-merging and CLI overrides — three things the
reference lacks (SURVEY.md §2.5).

The JSON key set is kept verbatim (UPPERCASE) so the reference's shipped
config files load unchanged.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Mapping


@dataclasses.dataclass(frozen=True)
class NeRFConfig:
    """Hyperparameters for one training/inference run.

    Field names map 1:1 to the reference's UPPERCASE JSON keys
    (reference: train_lego.py:37-50).  Extra TPU-native knobs (mesh shape,
    compute dtype, sampling mode, pallas toggle) have defaults that keep
    reference configs loading untouched.
    """

    # --- reference schema (config/*.json) ---
    batch_size: int = 256
    test_batch_size: int | None = None  # reference: fern configs only
    ns_coarse: int = 16
    ns_fine: int = 32
    height: int = 25
    width: int = 25
    l_xyz: int = 10
    l_dir: int = 4
    num_layers: int = 8
    hidden_dim: int = 256
    skip_layer: int = 4
    epochs: int = 1000
    learning_rate: float = 5e-4
    batch_norm: bool = False
    with_gcs: bool = False

    # --- TPU-native extensions (defaulted; absent from reference JSONs) ---
    compute_dtype: str = "bfloat16"  # matmul compute dtype; params stay f32
    sampling_mode: str = "stratified"  # 'stratified' | 'shared' | 'center'
    #   'stratified': per-ray per-sample jitter (standard NeRF; improvement)
    #   'shared': one jitter vector shared across the batch, drawn per step
    #             (closest jit-able analogue of reference data_utils.py:131-137)
    #   'center': deterministic linspace (reference rand_sampling=False)
    use_pallas: bool | None = None  # fused Pallas kernel for the MLP train path
    #   None (default): auto — enabled on TPU backends when compatible
    #   (no BatchNorm, no tensor parallelism); resolved at Trainer build.
    #   True/False: force.
    stop_pdf_gradient: bool = True
    #   True: detach coarse weights before inverse-CDF importance sampling
    #         (original-NeRF semantics; keeps the coarse head healthy — the
    #         interp denominator clamp at 1e-5 otherwise amplifies
    #         gradients into the coarse density head by up to 1e5x and the
    #         coarse rgb collapses; measured on the synthetic scene)
    #   False: reference-faithful — the reference never detaches
    #         (data_utils.py:172-223), so t-value gradients flow into the
    #         coarse MLP through the sampling CDF
    ndc: bool = False
    #   True: reparameterize rays into normalized device coordinates and
    #         sample t in [0, 1] — the original NeRF's treatment for
    #         forward-facing (LLFF) captures, absent from the reference
    #         (SURVEY.md §2.2).  Off by default to preserve reference
    #         parity; only meaningful for forward-facing datasets.
    train_sampler: str = "coarse"  # 'coarse' | 'proposal'
    #   'coarse': reference-parity training — an independent full-size
    #         coarse MLP places the fine samples and contributes an rgb
    #         loss (reference models.py:151-176).
    #   'proposal': beyond-reference — a tiny density net (Mip-NeRF-360-
    #         style proposal MLP, trained ONLINE by distilling the fine
    #         pass's compositing weights) places the fine samples instead.
    #         Removes the whole 8x256 coarse pass (~25% of the step's MLP
    #         FLOPs) and the checkpoint serves without post-training
    #         distillation.  Requires stop_pdf_gradient (the proposal is
    #         trained by its distillation loss, not through the CDF draw)
    #         and has no BatchNorm variant.
    prop_l_xyz: int = 4  # proposal net positional-encoding octaves
    prop_hidden: int = 64  # proposal net hidden width
    prop_depth: int = 3  # proposal net dense-layer count
    prop_loss_mult: float = 1.0  # weight of the online distillation loss
    prop_explore: float = 0.03  # uniform fraction mixed into the TRAINING
    #         CDF draw (never the loss, never eval/render): keeps fine
    #         samples flowing everywhere while the proposal sharpens —
    #         without it a flagship run showed a transient collapse
    #         (docs/PERF.md online-proposal section).  0 disables.
    prop_union: bool = True  # True: the fine pass evaluates the union of
    #         the NS_COARSE bin centers and the NS_FINE placed samples —
    #         the parity path's (NS_COARSE + NS_FINE) sample layout.
    #         False (Mip-NeRF-360 style): the fine net sees ONLY the
    #         NS_FINE proposal-placed samples (~33% fewer fine-pass
    #         FLOPs at flagship counts); PROP_EXPLORE keeps coverage.
    #         The converged cost is MOSTLY sample count: at NS_FINE=128
    #         ~-2 dB vs the union layout at 1.4x e2e throughput; at
    #         NS_FINE=192 (equal FLOPs) the gap shrinks to ~0.5 dB mean
    #         (25.33/24.37 vs union 25.59/25.22, seeds 42/7;
    #         anneal_quality_matrix.json).
    #         Only meaningful with TRAIN_SAMPLER='proposal'.
    prop_levels: int = 1  # proposal-chain depth (TRAIN_SAMPLER='proposal').
    #         1 (default): one tiny net places the fine samples from the
    #         NS_COARSE uniform bins — the round-3 online sampler.
    #         2: Mip-NeRF 360's stacked recipe — a second net re-bins at
    #         PROP_SAMPLES samples drawn from the first level's
    #         histogram, so the final draw's placement resolution follows
    #         the mass instead of the uniform grid.  Each level distills
    #         from the fine pass's weights binned into ITS OWN partition
    #         (exact aligned-bin MXU einsum — no outer-measure bound
    #         needed); anneal/explore shape every training draw.
    #         Measured (3-seed 80-epoch flagship matrix,
    #         docs/evidence/hier_prop_quality.json): on the UNION layout
    #         at 64+64 the chain converges 26.14/24.83/24.63 (s42/7/23)
    #         — mean +0.48 dB over the coarse 64+128 baseline, +0.9/
    #         +0.05/+0.3 over single-level 64+64, monotone, still rising
    #         at ep80.  On the union-FREE layout the chain does NOT
    #         close the converged gap (two variants measured, both below
    #         the single level): that gap is the loss of uniform-
    #         coverage supervision of the fine MLP, not placement
    #         (docs/PERF.md round-4).  Step cost ~+1.7 ms at flagship.
    prop_samples: int = 0  # refinement draws for PROP_LEVELS=2: how many
    #         stratified samples the first level places; the second
    #         level's partition is their UNION with the NS_COARSE
    #         uniform grid (coverage guaranteed — see
    #         ops/proposal.make_chain_sampler), so it evaluates at
    #         NS_COARSE + PROP_SAMPLES points per ray (~60x cheaper than
    #         fine-MLP points).  0 (default) = auto: NS_COARSE.
    prop_anneal_steps: int = 0  # Mip-NeRF 360 sampling anneal: for the
    #         first N optimizer steps the TRAINING CDF draw is softened
    #         by w^b with b = 10f/(1+9f), f = step/N (b: 0 -> 1), so
    #         early draws are near-uniform and sharpen to the raw
    #         proposal as it becomes trustworthy.  Draw-side only —
    #         never the loss, never eval/render.  0 (default) disables;
    #         -1 = auto (the training CLI resolves it to the full run
    #         horizon, epochs x steps-per-epoch, like LR_DECAY_STEPS=0;
    #         direct Trainer callers must resolve -1 themselves).
    #         Measured (3-seed 80-epoch flagship,
    #         docs/evidence/anneal_quality_matrix.json): with the union
    #         layout + DISTORTION_LOSS_MULT=1e-4 the full-horizon anneal
    #         converges 25.59/25.22/24.36 vs coarse 24.52/25.43/24.22 —
    #         mean +0.34 dB, worst seed -0.21 (inside the holdout's
    #         spread), monotone with no late decay — and collapses the
    #         seed variance the un-annealed arm shows (-1.8..+0.8 dB).
    #         Union-free layout: small gain when paired with
    #         PROP_EXPLORE=0.1 (22.70 vs 22.14 un-annealed at
    #         NS_FINE=128); the remaining union-free gap is sample
    #         count, not early starvation (see prop_union).
    prop_aux_samples: int = 0  # union-free coverage supervision (round 5):
    #         with PROP_UNION=false, render an AUXILIARY composite from
    #         this many fresh stratified-uniform samples per ray through
    #         the FINE MLP each training step, with its own image MSE
    #         (PROP_AUX_LOSS_MULT).  Rationale: the round-4 chain
    #         refutation proved the union-free converged gap is the fine
    #         MLP losing uniform-coverage supervision, not placement
    #         (docs/PERF.md round-4) — this restores that supervision at
    #         K/NS_FINE of the fine-pass cost instead of the union
    #         layout's NS_COARSE/NS_FINE.  Training-only: eval/render/
    #         serving stay on the union-free layout.  0 (default)
    #         disables; >= 2 (a 1-sample composite is all terminal
    #         delta).  Only meaningful with TRAIN_SAMPLER='proposal' and
    #         PROP_UNION=false.
    #         MEASURED (round 5, 80-epoch flagship matrix — docs/
    #         evidence/coverage_supervision_quality.json): 32 aux
    #         samples at NS_FINE=128 confirm the mechanism at seed 42
    #         (22.7 -> 25.72, ABOVE the official recipe) but fail the
    #         hard seeds (s7 21.33, s23 20.63-with-decay) and every
    #         reduced budget (aux16 20.63; NS_FINE 96/64 + aux32 lose
    #         even s42).  NOT a recipe — the aux loss constrains the
    #         density field, but the MAIN rgb loss still carries no
    #         gradient through un-placed regions.  Kept as the measured
    #         mechanism probe; see docs/PERF.md round-5.
    prop_aux_loss_mult: float = 1.0  # weight of the auxiliary coverage
    #         MSE above.  1.0 mirrors the reference's full-weight coarse
    #         rgb loss (models.py:88-120), which is the signal the union
    #         layout loses.
    prop_union_every: int = 0  # union-free interleave (round 5): with
    #         PROP_UNION=false, every Nth training step (step % N == 0)
    #         runs the UNION layout inside the same compiled step
    #         (lax.cond) — periodic uniform-coverage supervision of the
    #         fine MLP at amortized ~1/N of the union layout's extra
    #         cost.  Training-only; eval/render/serving stay union-free.
    #         0 (default) disables; >= 2 (1 would be every step — just
    #         set PROP_UNION=true).  Composes with PROP_AUX_SAMPLES (the
    #         aux pass rides the union-free steps only).
    #         MEASURED (round 5): REFUTED as a recipe — N=4 at
    #         NS_FINE=128 trains non-monotone to 20.25 at seed 42
    #         (WORSE than no coverage at all: the layout alternation
    #         destabilizes); N=2 passes s42 (25.21, above the official
    #         recipe — half-duty coverage suffices there) but fails
    #         both hard seeds (20.96/21.5-decaying).  docs/PERF.md
    #         round-5 matrix.
    prop_anneal_epochs: int = 0  # epoch-unit alternative to
    #         PROP_ANNEAL_STEPS (mutually exclusive; the train CLI
    #         converts epochs -> steps).  Pair with LR_DECAY_EPOCHS on
    #         long runs — the pinned-schedule long-horizon recipe is
    #         LR_DECAY_EPOCHS=PROP_ANNEAL_EPOCHS=80
    #         (docs/evidence/long_horizon_quality.json; the LR pin is
    #         the load-bearing one).
    prop_target_blur: bool | None = None  # [1/4, 1/2, 1/4] dilation of the
    #         binned fine-weights distillation target along the coarse
    #         bins (Mip-NeRF 360's histogram blur).  None (default) =
    #         layout rule: blur iff PROP_UNION=false, where the target is
    #         a high-variance sample-placement estimate (measured 1-2 dB;
    #         docs/PERF.md).  Explicit True with the union layout
    #         measured no benefit (25.24 at the 1e-3+anneal seed-42 arm,
    #         vs 25.52 without blur) — leave on auto.
    distortion_loss_mult: float = 0.0  # weight of Mip-NeRF 360's
    #         distortion regularizer on the FINE pass's compositing
    #         weights (ops/volume.distortion_loss): pulls each ray's mass
    #         into one compact cluster (anti-floater / anti-background-
    #         collapse).  0 (default) disables — reference parity (the
    #         reference has no geometry regularizer).  Runs on BOTH train
    #         paths: the fused megakernel accepts a weights cotangent
    #         (render_rays_fused weights_grad) so the regularizer rides
    #         the fast path too.  Measured (80-epoch flagship A/B,
    #         docs/evidence/distortion_ab.json): 1e-3 gains +1.6 dB val
    #         PSNR over the unregularized arm; 1e-2 over-regularizes
    #         (-3 dB).  Start at 1e-3 — EXCEPT with
    #         TRAIN_SAMPLER='proposal', where 1e-3 is seed-fragile with
    #         or without the anneal (3-seed: 25.52/19.68/19.68 annealed;
    #         22.16 un-annealed — strong distortion sharpens the fine
    #         weight histogram that is the proposal's distillation
    #         target); use 1e-4 there — monotone at all 3 seeds
    #         (docs/evidence/anneal_quality_matrix.json).  The midpoint
    #         3e-4 was probed at the official 64+96 proposal recipe and
    #         is a seed lottery even WITH the full-horizon anneal
    #         (26.31/24.31/24.92 vs 1e-4's 25.08/25.67/24.62; monotone
    #         but slower-converging on 2 of 3 seeds at the 80-epoch
    #         budget — docs/evidence/sample_budget_quality.json).
    white_bkgd: bool = False  # composite rays onto a WHITE background:
    #         rgb' = rgb + (1 - sum(weights)) (vanilla NeRF's Blender-set
    #         treatment, ops/volume.composite_background).  The reference
    #         always composites onto black, forcing the model to explain
    #         white background pixels with a glowing shell/fog — off by
    #         default for parity.  Applies to every path (train losses,
    #         eval, float/int8/proposal renders); on the fused train path
    #         the (1 - acc) term's weight-gradients ride the megakernel's
    #         weights-cotangent backward.
    lr_final: float | None = None  # enables exponential learning-rate decay
    #         from LEARNING_RATE down to LR_FINAL over LR_DECAY_STEPS
    #         optimizer steps (the original NeRF's lrate_decay treatment;
    #         the reference trains at a constant Keras-default LR for its
    #         whole schedule).  None (default) = constant LR, reference
    #         parity.  Measured motivation: constant-LR flagship runs
    #         wobble/collapse late on the synthetic holdout
    #         (docs/PERF.md 80-epoch close-out).
    lr_decay_steps: int = 0  # horizon of the decay above, in optimizer
    #         steps.  0 = auto: the train CLI fills in epochs *
    #         steps-per-epoch once the dataset size is known; building an
    #         optimizer directly with LR_FINAL set and no horizon raises.
    lr_decay_epochs: int = 0  # epoch-unit alternative to LR_DECAY_STEPS
    #         (mutually exclusive; the train CLI converts epochs ->
    #         steps once the dataset size is known).  Motivation
    #         (docs/evidence/long_horizon_quality.json): on runs well
    #         past ~80 epochs, auto-stretching the decay to the full
    #         horizon keeps the LR high too long and collapses fragile
    #         seeds (s7: 22.79 -> 17.96 at 200 epochs); pinning the
    #         horizon at ~80 epochs made both seeds rise monotonically
    #         through ep200 (26.91/25.85).  "LR_DECAY_EPOCHS": 80 is
    #         that rule, scene-independent.
    ema_decay: float = 0.0  # exponential moving average of the params,
    #         updated every step (ema = d*ema + (1-d)*params) and used for
    #         ALL eval/render/serving paths when enabled; the raw params
    #         keep training.  0 (default) disables — reference parity.
    #         Standard stabilizer for noisy NeRF holdout evals (e.g.
    #         Instant-NGP); the EMA is checkpointed alongside the params.
    freq_anneal_steps: int = 0  # coarse-to-fine FREQUENCY ANNEAL of the
    #         positional encoding (FreeNeRF / Nerfies eq. 8): for the
    #         first N optimizer steps the high encode octaves are masked
    #         and eased in one by one, so early training fits the scene
    #         layout before the high-frequency capacity can memorize the
    #         training views — the standard remedy for the few-view
    #         collapse documented in docs/PERF.md (val stuck ~11 dB under
    #         a climbing train curve).  0 (default) disables — reference
    #         parity; -1 = auto (the training CLI resolves it to the full
    #         run horizon like PROP_ANNEAL_STEPS; direct Trainer callers
    #         must resolve -1 themselves).  Implemented as a weight FOLD
    #         (ops/freq_anneal.py): the window scales the rows of the
    #         encode-consuming matrices inside the jitted step, so every
    #         path (XLA, Pallas megakernel, int8) gets it with zero
    #         kernel changes, and masked octaves receive exactly zero
    #         gradient (they stay at init until their window opens).
    #         Eval/render/derived artifacts fold the CURRENT step's
    #         window; after the horizon the window is identity, so
    #         completed checkpoints behave exactly like un-annealed ones.
    #         Positions only (both nets, incl. the proposal net's own
    #         encoding); view directions are never annealed.  No
    #         BatchNorm variant (BN renormalizes per-channel batch stats,
    #         which interacts with the row scaling).
    freq_anneal_epochs: int = 0  # epoch-unit alternative to
    #         FREQ_ANNEAL_STEPS (mutually exclusive; the train CLI
    #         converts epochs -> steps once the dataset size is known).
    mesh_data: int = -1  # -1: all devices on the data axis
    mesh_model: int = 1  # >1 enables tensor-parallel MLP sharding
    seed: int = 42  # reference: keras.utils.set_random_seed(42), train_lego.py:22
    eval_every: int | None = None  # epochs between eval/checkpoint; None =
    #   use the entry point's default (reference cadence: 1 for single-
    #   device scripts, 50/10 for the TPU ones).  An explicit EVAL_EVERY in
    #   the JSON always wins — including EVAL_EVERY=1.
    log_every: int = 0  # steps between per-step metric prints (0 = off)

    @property
    def xyz_dim(self) -> int:
        """Encoded position width: 3 + 2*3*l_xyz (reference models.py:25)."""
        return 3 + 2 * 3 * self.l_xyz

    @property
    def dir_dim(self) -> int:
        """Encoded direction width: 3 + 2*3*l_dir (reference models.py:26)."""
        return 3 + 2 * 3 * self.l_dir

    @property
    def ns_total(self) -> int:
        """Samples per ray seen by the fine MLP (reference models.py:167)."""
        return self.ns_coarse + self.ns_fine

    def validate(self) -> "NeRFConfig":
        if self.batch_size <= 0:
            raise ValueError(f"batch_size must be positive, got {self.batch_size}")
        if self.ns_coarse < 2:
            raise ValueError(f"ns_coarse must be >= 2, got {self.ns_coarse}")
        if self.ns_fine < 0:
            raise ValueError(f"ns_fine must be >= 0, got {self.ns_fine}")
        if self.skip_layer <= 0:
            raise ValueError(f"skip_layer must be positive, got {self.skip_layer}")
        if self.sampling_mode not in ("stratified", "shared", "center"):
            raise ValueError(f"unknown sampling_mode: {self.sampling_mode!r}")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown compute_dtype: {self.compute_dtype!r}")
        if self.eval_every is not None and self.eval_every < 1:
            raise ValueError(f"eval_every must be >= 1, got {self.eval_every}")
        if self.use_pallas and self.batch_norm:
            # The fused kernels carry no BatchNorm state; without this
            # check a direct make_*_step caller would silently train/eval
            # without BN (Trainer has the same guard for resolved configs).
            raise ValueError(
                "use_pallas=True is incompatible with batch_norm=True "
                "(the fused kernels have no BatchNorm support); use the "
                "XLA path for BN configs"
            )
        if self.use_pallas and self.mesh_model > 1:
            # Same direct-caller rationale: the Pallas path shard_maps
            # over the data axis only, so a tensor-parallel mesh would
            # silently mis-shard the params (Trainer has this guard too).
            raise ValueError(
                "use_pallas=True shards rays over 'data' only; tensor "
                "parallelism (MESH_MODEL > 1) requires the jnp MLP path"
            )
        if not self.prop_union and self.train_sampler != "proposal":
            raise ValueError(
                "PROP_UNION=false only applies to TRAIN_SAMPLER='proposal' "
                "(the parity path always unions coarse and fine samples)"
            )
        if self.prop_levels != 1 and self.train_sampler != "proposal":
            raise ValueError(
                "PROP_LEVELS configures the proposal chain; it only "
                "applies to TRAIN_SAMPLER='proposal'"
            )
        if self.prop_samples != 0 and self.train_sampler != "proposal":
            raise ValueError(
                "PROP_SAMPLES configures the proposal chain; it only "
                "applies to TRAIN_SAMPLER='proposal'"
            )
        if self.prop_anneal_steps != 0 and self.train_sampler != "proposal":
            raise ValueError(
                "PROP_ANNEAL_STEPS anneals the proposal draw; it only "
                "applies to TRAIN_SAMPLER='proposal'"
            )
        if self.prop_aux_samples != 0 and self.train_sampler != "proposal":
            raise ValueError(
                "PROP_AUX_SAMPLES supervises the union-free proposal "
                "layout; it only applies to TRAIN_SAMPLER='proposal'"
            )
        if self.prop_union_every != 0 and self.train_sampler != "proposal":
            raise ValueError(
                "PROP_UNION_EVERY interleaves proposal layouts; it only "
                "applies to TRAIN_SAMPLER='proposal'"
            )
        if self.train_sampler not in ("coarse", "proposal"):
            raise ValueError(
                f"unknown train_sampler: {self.train_sampler!r} "
                "(expected 'coarse' or 'proposal')"
            )
        if self.train_sampler == "proposal":
            if not self.stop_pdf_gradient:
                raise ValueError(
                    "TRAIN_SAMPLER='proposal' requires STOP_PDF_GRADIENT: "
                    "the proposal net is trained by its distillation loss, "
                    "not through the inverse-CDF draw"
                )
            if self.batch_norm:
                raise ValueError(
                    "TRAIN_SAMPLER='proposal' has no BatchNorm variant; "
                    "use the coarse sampler for BN configs"
                )
            if self.ns_fine <= 0:
                raise ValueError(
                    "TRAIN_SAMPLER='proposal' places fine samples; "
                    "NS_FINE must be positive"
                )
            if not 0.0 <= self.prop_explore < 1.0:
                raise ValueError(
                    "PROP_EXPLORE is the uniform fraction of the training "
                    f"draw; need 0 <= e < 1, got {self.prop_explore}"
                )
            if self.prop_anneal_steps < -1:
                raise ValueError(
                    "PROP_ANNEAL_STEPS is a step count (0 disables, "
                    f"-1 = auto/full-horizon); got {self.prop_anneal_steps}"
                )
            if self.prop_levels not in (1, 2):
                raise ValueError(
                    f"PROP_LEVELS must be 1 or 2, got {self.prop_levels}"
                )
            if self.prop_samples < 0 or self.prop_samples == 1:
                raise ValueError(
                    "PROP_SAMPLES is the level-2 partition size (0 = auto "
                    f"= NS_COARSE, else >= 2); got {self.prop_samples}"
                )
            if self.prop_samples > 0 and self.prop_levels < 2:
                raise ValueError(
                    "PROP_SAMPLES only applies to the PROP_LEVELS=2 chain"
                )
            if self.prop_aux_samples < 0 or self.prop_aux_samples == 1:
                raise ValueError(
                    "PROP_AUX_SAMPLES is the auxiliary coverage-composite "
                    "size (0 disables, else >= 2 — a 1-sample composite "
                    f"is all terminal delta); got {self.prop_aux_samples}"
                )
            if self.prop_aux_samples > 0 and self.prop_union:
                raise ValueError(
                    "PROP_AUX_SAMPLES restores uniform-coverage "
                    "supervision to the UNION-FREE layout; the union "
                    "layout already has it (set PROP_UNION=false)"
                )
            if self.prop_aux_loss_mult < 0:
                raise ValueError(
                    f"PROP_AUX_LOSS_MULT must be >= 0, got "
                    f"{self.prop_aux_loss_mult}"
                )
            if self.prop_union_every < 0 or self.prop_union_every == 1:
                raise ValueError(
                    "PROP_UNION_EVERY interleaves union steps into "
                    "union-free training (0 disables, else >= 2; every "
                    "step = just set PROP_UNION=true); got "
                    f"{self.prop_union_every}"
                )
            if self.prop_union_every > 0 and self.prop_union:
                raise ValueError(
                    "PROP_UNION_EVERY only applies to PROP_UNION=false "
                    "(the union layout runs every step already)"
                )
            if min(self.prop_l_xyz, self.prop_hidden) < 1 or self.prop_depth < 2:
                raise ValueError(
                    "proposal net needs PROP_L_XYZ/PROP_HIDDEN >= 1 and "
                    f"PROP_DEPTH >= 2; got l_xyz={self.prop_l_xyz} "
                    f"hidden={self.prop_hidden} depth={self.prop_depth}"
                )
        if self.distortion_loss_mult < 0:
            raise ValueError(
                f"DISTORTION_LOSS_MULT must be >= 0, got "
                f"{self.distortion_loss_mult}"
            )
        if self.lr_final is not None:
            if not 0.0 < self.lr_final <= self.learning_rate:
                raise ValueError(
                    "LR_FINAL is the decayed floor of the schedule; need "
                    f"0 < LR_FINAL <= LEARNING_RATE, got {self.lr_final} "
                    f"vs {self.learning_rate}"
                )
        if self.lr_decay_steps < 0:
            raise ValueError(
                f"LR_DECAY_STEPS must be >= 0 (0 = auto), got "
                f"{self.lr_decay_steps}"
            )
        if self.lr_decay_epochs < 0:
            raise ValueError(
                f"LR_DECAY_EPOCHS must be >= 0 (0 = unset), got "
                f"{self.lr_decay_epochs}"
            )
        if self.lr_decay_epochs > 0 and self.lr_decay_steps > 0:
            raise ValueError(
                "LR_DECAY_EPOCHS and LR_DECAY_STEPS both set — pick one "
                "horizon unit (epochs are converted to steps by the "
                "train CLI)"
            )
        if self.prop_anneal_epochs < 0:
            raise ValueError(
                f"PROP_ANNEAL_EPOCHS must be >= 0 (0 = unset), got "
                f"{self.prop_anneal_epochs}"
            )
        if self.prop_anneal_epochs > 0 and self.prop_anneal_steps != 0:
            raise ValueError(
                "PROP_ANNEAL_EPOCHS and PROP_ANNEAL_STEPS both set — pick "
                "one horizon spec (epochs are converted to steps by the "
                "train CLI)"
            )
        if self.prop_anneal_epochs != 0 and self.train_sampler != "proposal":
            raise ValueError(
                "PROP_ANNEAL_EPOCHS anneals the proposal draw; it only "
                "applies to TRAIN_SAMPLER='proposal'"
            )
        if not 0.0 <= self.ema_decay < 1.0:
            raise ValueError(
                f"EMA_DECAY must be in [0, 1), got {self.ema_decay}"
            )
        if self.freq_anneal_steps < -1:
            raise ValueError(
                "FREQ_ANNEAL_STEPS is a step count (0 disables, "
                f"-1 = auto/full-horizon); got {self.freq_anneal_steps}"
            )
        if self.freq_anneal_epochs < 0:
            raise ValueError(
                f"FREQ_ANNEAL_EPOCHS must be >= 0 (0 = unset), got "
                f"{self.freq_anneal_epochs}"
            )
        if self.freq_anneal_epochs > 0 and self.freq_anneal_steps != 0:
            raise ValueError(
                "FREQ_ANNEAL_EPOCHS and FREQ_ANNEAL_STEPS both set — pick "
                "one horizon unit (epochs are converted to steps by the "
                "train CLI)"
            )
        if (
            self.freq_anneal_steps != 0 or self.freq_anneal_epochs != 0
        ) and self.batch_norm:
            raise ValueError(
                "FREQ_ANNEAL has no BatchNorm variant: the window scales "
                "encode-consuming weight rows, which BN's per-channel "
                "batch statistics would partially renormalize away"
            )
        if self.mesh_data == 0 or self.mesh_data < -1:
            raise ValueError(
                f"MESH_DATA must be >= 1 or -1 (all devices), got "
                f"{self.mesh_data}"
            )
        return self


# reference JSON key -> dataclass field
_KEY_MAP = {
    "BATCH_SIZE": "batch_size",
    "TEST_BATCH_SIZE": "test_batch_size",
    "NS_COARSE": "ns_coarse",
    "NS_FINE": "ns_fine",
    "HEIGHT": "height",
    "WIDTH": "width",
    "L_XYZ": "l_xyz",
    "L_DIR": "l_dir",
    "NUM_LAYERS": "num_layers",
    "HIDDEN_DIM": "hidden_dim",
    "SKIP_LAYER": "skip_layer",
    "EPOCHS": "epochs",
    "LEARNING_RATE": "learning_rate",
    "BATCH_NORM": "batch_norm",
    "WITH_GCS": "with_gcs",
    # extensions keep UPPERCASE style for uniformity in JSON files
    "COMPUTE_DTYPE": "compute_dtype",
    "SAMPLING_MODE": "sampling_mode",
    "USE_PALLAS": "use_pallas",
    "STOP_PDF_GRADIENT": "stop_pdf_gradient",
    "NDC": "ndc",
    "TRAIN_SAMPLER": "train_sampler",
    "PROP_L_XYZ": "prop_l_xyz",
    "PROP_HIDDEN": "prop_hidden",
    "PROP_DEPTH": "prop_depth",
    "PROP_LOSS_MULT": "prop_loss_mult",
    "PROP_LEVELS": "prop_levels",
    "PROP_SAMPLES": "prop_samples",
    "PROP_EXPLORE": "prop_explore",
    "PROP_UNION": "prop_union",
    "PROP_TARGET_BLUR": "prop_target_blur",
    "PROP_ANNEAL_STEPS": "prop_anneal_steps",
    "PROP_ANNEAL_EPOCHS": "prop_anneal_epochs",
    "PROP_AUX_SAMPLES": "prop_aux_samples",
    "PROP_AUX_LOSS_MULT": "prop_aux_loss_mult",
    "PROP_UNION_EVERY": "prop_union_every",
    "DISTORTION_LOSS_MULT": "distortion_loss_mult",
    "WHITE_BKGD": "white_bkgd",
    "LR_FINAL": "lr_final",
    "LR_DECAY_STEPS": "lr_decay_steps",
    "LR_DECAY_EPOCHS": "lr_decay_epochs",
    "EMA_DECAY": "ema_decay",
    "FREQ_ANNEAL_STEPS": "freq_anneal_steps",
    "FREQ_ANNEAL_EPOCHS": "freq_anneal_epochs",
    "MESH_DATA": "mesh_data",
    "MESH_MODEL": "mesh_model",
    "SEED": "seed",
    "EVAL_EVERY": "eval_every",
    "LOG_EVERY": "log_every",
}


def config_from_dict(raw: Mapping[str, Any]) -> NeRFConfig:
    """Build a validated config from a flat reference-schema dict."""
    kwargs = {}
    unknown = []
    for key, value in raw.items():
        field = _KEY_MAP.get(key)
        if field is None:
            unknown.append(key)
        else:
            kwargs[field] = value
    if unknown:
        raise ValueError(
            f"unknown config keys {unknown}; known keys: {sorted(_KEY_MAP)}"
        )
    return NeRFConfig(**kwargs).validate()


def load_config(path: str, **overrides: Any) -> NeRFConfig:
    """Load a reference-schema JSON config, with keyword overrides.

    Mirrors the reference CLI contract (``--config config/<name>.json``,
    train_lego.py:25-31).
    """
    with open(path) as f:
        raw = json.load(f)
    cfg = config_from_dict(raw)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides).validate()
    return cfg


def config_name(path: str) -> str:
    """Basename without extension, used in run-dir names (train_lego.py:34)."""
    return os.path.splitext(os.path.basename(path))[0]


def to_reference_json(cfg: NeRFConfig) -> dict:
    """Serialize back to the reference's UPPERCASE flat-JSON schema."""
    inv = {v: k for k, v in _KEY_MAP.items()}
    out = {}
    for field in dataclasses.fields(cfg):
        value = getattr(cfg, field.name)
        if field.name in ("test_batch_size", "eval_every", "lr_final") and value is None:
            continue
        out[inv[field.name]] = value
    return out
