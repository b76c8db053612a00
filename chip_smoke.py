"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --profile-training   # phases 1, 2, a profile, MFU
    python3 chip_smoke.py --profile-training-type-only  # the type losses
    python3 chip_smoke.py --profile-vqvae      # the same for the VQ-VAE step
    python3 chip_smoke.py --profile-vq-core    # K4's time split by kernel
    python3 chip_smoke.py --profile-vq-assign  # K5's and K7's, and by N

Phases, each of which passes or raises (any failure exits non-zero):

1. print the card's name and power limit (nvidia-smi);
2. build the CUDA sources of ``forest_tpu_torch/csrc``: ``bank_mix_fwd``
   (K1), ``bank_mix_bwd`` (K2), ``scatter_add_rows`` (K3), ``vq_assign``
   (K4 ``vq_core`` and K5 ``vq_assign``) and ``vq_variants`` (K6, K7), one
   ``nvcc`` each, all started together;
3. hold K1 to its plain PyTorch version on the card at the serving shape
   [8, 256, 256, 48] (R = 4, coarse dilation 3) in float32 and bfloat16 and
   at an odd shape [2, 33, 37, 5], and time both; the same at the training
   shape [12, 256, 256, 48] in bfloat16; untimed at [1, 70, 37, 48],
   [1, 40, 70, 8] and [2, 40, 37, 5], which cross a strip and a segment
   border of the kernel's tiling with a ragged last strip, on each of its
   three paths; two runs bit-identical at every shape;
4. hold K2 (dx, dA, dB) to its plain version (the gradient of the plain
   forward written out, ``bank_mix_bwd_reference``) at [12, 256, 256, 48]
   in float32 and bfloat16 and time both;
   untimed at [2, 33, 37, 5] and at [1, 130, 70, 48], [2, 70, 37, 5] and
   [1, 70, 40, 8], which cross a strip and a segment border of the kernel's
   tiling with a width that is no multiple of the strip, on each of the
   kernel's three paths (C = 48 at compile time, an even C, an odd C);
5. hold K3 to its plain version (``index_add_`` per sample) at
   [12, 2012, 48] -> [12, 65536, 48] with duplicated indices and at a small
   odd shape; time the form the training step runs (no host check of the
   indices), the public form with the check, the plain version and one
   ``index_add_`` call; two runs compared bit for bit; small-integer data
   with ~75 rows per destination, which must equal the plain version
   exactly; an index out of range, where the public form must raise
   ``IndexError`` and the unchecked form must leave the bad rows out and
   equal the plain version of the remaining rows exactly;
6. build the v1 encoder from ``configs/frl_repr_model_v1.yaml`` with seeded
   random weights, write it as a flax-layout checkpoint with the synthetic
   bindings and stats into a temporary directory;
7. serve it with ``forest_tpu_torch.serving.EncoderService`` (device cuda,
   max batch 8) behind the HTTP front and POST concurrent 256 x 256
   requests, some with dense phase embeddings; check shapes and finiteness;
   check the serving run launched K1, and that one response equals the same
   model run with the plain version of the kernel, within the bfloat16
   bound below;
8. train: the same v1 model (bf16 smoothing), a synthetic batch of 12
   patches of 256 x 256 x 15 years, 300 anchors per patch, the full
   ``process_batch`` under ``make_train_step`` on ``cuda`` with
   ``step.DEFAULT_WEIGHTS`` (configs/frl_training_v1.yaml's weights at full
   ramp: the eight non-EVT losses on, the phase pathway included). First
   one step's ``loss_total`` and ``grad_norm`` with the kernels against the
   same step, same draws, with the kernels' plain versions swapped in. Then,
   with the launch counts set to 0, 2 warm and 5 timed steps: every metric
   and weighted loss finite, phase pairs found, ``skipped`` 0, every
   parameter tensor of the phase pathway (and the type pathway's) changed,
   K1, K2 and K3 each launched at least once per step; the step's time
   (median, min, max), one step split into forward, backward and optimizer,
   and peak memory. Then one step more with the EVT loss on (weight 0.1,
   tables from a confusion CSV over the batch's codes 7001-7003 written into
   a temporary directory) and ``diag=True``, against its plain-kernel twin
   with the same bounds: ``loss_evt`` finite and non-zero, all 106
   diagnostics finite;
9. hold K4 ``ops.vq.vq_core`` to its plain version at the bench shape
   N 131072, D 128, K 256 with ``with_qx``, at the train step's (64, 128,
   256), at N 1, 63, 65, 127, 128, 129 and 845 (the edges of its one-launch
   path and a cut between segments of its statistics pass) and at (333, 24,
   17) and (5, 7, 3): its indices equal K5's bit for bit; the indices by a
   rule stated in
   float64 (``argmin_rule``), q and counts exactly, sums and sum(q * x) to
   1e-5 relative; a NaN input row and a NaN codebook row; small-integer
   data with duplicated codes, where every output must equal the plain
   version's bit for bit; two runs bit-identical in every output; an empty
   input. Timed against the plain version and a composition of PyTorch
   calls for the same outputs (TF32 off); then its time split by kernel
   (``torch.profiler``), its launches per call (one at N 64) and its time
   from call to return, at the bench shape and at (64, 128, 256);
10. the same for K5 ``ops.vq.vq_assign`` in float32 and with bfloat16
    operands, with the path each shape takes (``vq_assign_path``: the
    resident float32 product and the tensor cores at the bench shape); its
    float32 indices must equal K4's exactly at every shape; bfloat16
    operands by the float64 rule, two runs bit for bit, integer inputs
    exactly; timed beside ``addmm`` + ``argmin``;
11. hold K6 and K7 (``ops.vq_variants.make_assign`` / ``make_assign_t``) to
    their plain versions knob by knob (bfloat16 operands, bfloat16 storage,
    ``argmin=False`` on each of K6's products, x given transposed or not);
    at the tiles 512, 1024, 2048 and 4096 each must give the same indices,
    on the resident path in float32 (equal to K5's float32 indices) and on
    the tensor cores with rounded operands (K6's equal to K5's bfloat16
    indices); then run the sweep ``vq_variants.main()`` with fewer
    iterations for the times (K7 per tile, K6's row beside them) and time
    K6's rounded variants;
12. the legacy VQ-VAE: build a synthetic 256 x 256 cube (5 years, 8
    continuous, 2 categorical, 3 NAIP bands) in a temporary directory; one
    train step with K4 against the same step with its plain version swapped
    in (indices equal, ``loss/total`` within 1e-6); then, with the launch
    counts set to 0, ``train_vqvae.main`` on ``configs/vae_v0.yaml`` for 2
    epochs of 100 steps on ``cuda``: two history rows, every metric finite,
    the second epoch's ``train/loss_total`` below the first's, perplexity
    above 1, ``ckpt_last.msgpack`` written, K4 launched exactly once per
    train and validation step; ``export_codebook.export`` and the shapes of
    its npz, whose usage must sum to steps x 64; 50 timed steps on a
    resident batch;
13. the committed blosc-LZ4 v2 cube (``tests/torch_fixtures/blosc_lz4_v2``,
    written by the JAX package's cube_v2 writer) on this machine, which has no
    libblosc: the native decoder must have built; every chunk through the
    native and the Python decoder, byte for byte; every array through each
    against ``checksums.json``, the native one having decoded every chunk;
    ``ForestDatasetV2`` patches of 32 x 32 from the fixture's bindings and
    one through ``FeatureBuilder`` on the card, finite; a new array with the
    default compressor (zlib where libblosc does not load) read back;
14. the FRL training CLI as a user runs it: a synthetic v2 cube of 1536 x
    1536 (chunks of 256; ``configs/frl_training_v1.yaml``'s split cuts it
    into 16 train and 4 val patches of 256) in a temporary directory, then
    ``train_representation.main`` on that YAML (its run root moved into the
    temporary directory) and ``configs/frl_repr_model_v1.yaml`` unchanged,
    the production sampling (300 anchors), B 12, for 2 epochs with
    ``--phase-start-epoch 0`` (the phase losses on in epoch 1; the CLI
    computes the stats), then resumed to 3 epochs under ``--profile``: the
    resumed run must start at epoch 2 with the saved step; every loss
    finite, ``skipped`` 0, phase pairs in epoch 1, K1 launched on every
    train and validation step, K2 and K3 on every train step; the last
    checkpoint served by ``EncoderService`` for one 256 x 256 request and
    held to the plain model within phase 7's bound. Printed: per epoch the
    steps, ms per step, the loader's wait share, the epoch's time and both
    losses; the cube's build and the stats' time; host synchronisations
    per step from the profiled epoch's trace;
15. the eval tools as a user runs them, on phase 14's cube and the last
    checkpoint it trained (the v1 widths, bf16 smoothing), each with the
    launch counts set to 0 just before it and read just after: (a)
    ``export_embeddings.main`` with ``--phase`` over all 36 patches of 256
    (batches of 4): float16 ``z_type`` [1536, 1536, 48] and ``z_phase``
    [15, 1536, 1536, 8], finite inside the AOI, one patch within phase 7's
    bound of the model run with K1's plain version, K1 launched on every
    batch; (b) ``embed_locations.main`` on 50 points (5 off the cube) at
    patches of 256: every column family, ``valid`` 0 off the cube, each
    point's ``z_type_*`` within a float16 rounding of (a)'s export there;
    (c) ``train_probe.main`` for 2 epochs on ``infonce_type_spectral``
    (patches of 128, B 4): two history rows, a finite val R^2,
    ``probe_best.npz`` and ``probe_final.npz``; (d) ``phase_probe.main``
    with ``--design full``: finite train and val metrics, W of [8 + 48 +
    20 + 1, C]. Printed: each tool's seconds and K1's launches, the
    export's patches per second and MB written, and where one of its
    batches' time goes (decode, copy, the card's time, copy back, zarr
    write);
16. the clustering and FIA tools as a user runs them, on phase 14's cube
    and checkpoint, each with the launch counts set to 0 just before it
    and read just after: (a) ``eval.gmm.main`` at its defaults (patches of
    128, capacity 100,000, components 4 8 16 24 32) with ``--evt-source
    static_categorical.evt``: a best K among them, finite BICs, a label per
    sampled pixel, K1 launched on every batch; (b)
    ``eval.landscape_categories.main`` at its defaults (500,000 pixels, K
    5-50 step 5, 3 inits, silhouettes on 20,000) but a dynamic-variance
    threshold of 0, so that every type cluster of 1,000 pixels or more gets
    its phase sweep and the second pass runs: ``taxonomy.json`` over every
    pixel fit and the pickles, K1 launched on every batch of both passes;
    then one diag GMM fit at K 25 on the 500,000 pixels, timed alone; (c)
    ``embed_locations`` on 2,000 points inside the AOI and forest, a seeded
    synthetic target pair, a unit and an auxiliary column added, and
    ``eval.fia.main`` with each of ``hierarchical``, ``hdbscan``,
    ``removals`` and ``probe_table``:
    finite tables over 2,000 plots; (d) one GMM fit, one KMeans fit and one
    HDBSCAN run on the card against the same calls on the CPU from the same
    host draws (the check where a kernel's plain version would stand):
    labels equal, parameters within 1e-6 relative. Between (a) and (b),
    the type forward on gmm's first batch (4 train patches of 128) with K1
    and with its plain version swapped in, z_type within 2^-5 relative.
    Printed: each tool's seconds, the pixels fit, the timed fit's
    iterations and seconds, and K1's launches;
17. the diagnostics tools and the reference-checkpoint import as a user
    runs them, on phase 14's cube and checkpoint, each CLI with the launch
    counts set to 0 just before it and read just after: (a)
    ``eval.visualize.main`` with ``--probe --forest-diag`` at its defaults
    (4 test patches of 256): it ends and counts its figures (none where
    matplotlib does not import, each skip logged), K1 launched for every
    patch of its four per-patch families; then the gate forward
    (``return_gate``) on the first-ranked patch with K1 and with its plain
    version, z_type and the gate within 2^-5 relative, and
    ``collect_forest_diag_records`` on that patch on the card and on the
    CPU from the same phase probe (fit on the card): masks and ysfc_min
    equal, observed targets within 1e-5, predictions within 2^-5 relative;
    (b) ``eval.phase_diagnostics.main --probe`` at its defaults (8 train
    patches) on the card and on the CPU: the same files, the summaries'
    EVT classes and pixel counts equal, every CSV cell within 2^-5 of its
    column's scale (``ysfc_by_evt.csv`` byte for byte); (c) phase 14's
    encoder written as a reference trainer's ``.pt`` (its weights under the
    reference's names and layouts, the reference's config schema) through
    ``utils.torch_import.main``: the imported params equal the trained ones
    bit for bit, and the import, loaded by ``frozen.load_frozen_model`` on
    the card (float32, as the reference's config carries no compute
    dtype), encodes one test patch with K1 within 1e-4 relative of its
    plain version; (d) HDBSCAN on 60,000 points of four blobs in 56
    dimensions (min 40), whose dense matrices the earlier fit would have
    needed 3 x 28.8 GB for: four clusters, the allocator's peak below
    1 GiB. Printed: each tool's seconds, the CPU runs' seconds, K1's
    launches, the errors, HDBSCAN's seconds and peak memory, and the
    phase's time;
18. the cube builders as a user runs them, on GeoTIFFs written here: the
    sources of a tripartite dataset YAML of the reference schema on a 2048
    x 2048 grid at 30 m (UTM 17N, about 61 km square), 5 years --
    per-year (with a ``fill_value`` mapping), multiband and per-band (a VRT
    mosaic) annual groups, an irregular group, static continuous,
    categorical (clipped from a source twice the grid's extent) and mask
    groups, AOI and strata, and one static band in EPSG:4326 resampled
    bilinear onto the grid -- written by ``build_zarr_v2.
    synthesize_sources`` and then rewritten by the port's codec as
    Deflate tiles, Deflate and LZW with the floating point predictor, LZW
    with the horizontal predictor and PackBits beside uncompressed files;
    the codec's decode rate by layout; whether PIL imports on the machine
    (where it does, its decode of every source page held to the port's);
    ``build_zarr_v2.main`` with ``--device cuda`` and again with
    ``--device cpu``: the arrays byte for byte but the reprojected band,
    whose float64 values agree to 1e-9 of its scale and which each cube
    stores as its own float16 rounding, attrs equal, statistics and the
    JSON sidecar within 1e-12 (float64 sums in another order);
    ``zarr_info.main`` on the cube on the card and on the CPU (the same
    report and counts); ``zarr_builder.main`` and ``manifest_stack.main``
    on 512 x 512 inputs of their own on the card and on the CPU (equal
    cubes); then 4 patches of 256 of the built cube through
    ``ForestDatasetV2`` and ``FeatureBuilder`` (normalised by the
    statistics the builder embedded) into the v1 ``RepresentationModel``
    with seeded weights and the cube's three static bands as input: K1
    counted from 0 on that forward, then held to its plain version
    (SERVE_REL_BOUND). Printed: each build's seconds by layer (decode,
    the passes on the device with the reprojection and the statistics,
    the zarr write and its raw MB/s), each tool's seconds on the card and on
    the CPU, the codec's MB/s by layout, and K1's launches and error;
19. data parallel, run after phase 18 on phase 14's cube, stats and
    configs (the machine has one card, and NCCL refuses two ranks on one
    card): (a) ``torchrun --standalone --nproc_per_node 1`` of the FRL CLI
    (``hardware.data_parallel: true``, one epoch, the phase losses on) and
    of the VQ-VAE CLI (``configs/vae_v0.yaml`` with ``data_parallel:
    true``, one epoch of 20 steps on a 256² legacy cube), NCCL at world
    size 1, each against the same CLI run by ``python -m`` with no group,
    the four at once: history within phase 8's bounds (losses 1e-5, the
    gradient norm 1e-4) and the final parameters within 1e-4 of their
    norm; (b) two ranks of this script (``--dp-rank``) sharing the card
    over gloo, chosen explicitly, on CUDA tensors: each runs 2 steps of
    the full FRL step (the v1 model at full width, ``DEFAULT_WEIGHTS``, 300
    anchors, 256², global batch 12, 6 a rank) and 2 VQ-VAE steps
    (``configs/vae_v0.yaml``, 64 rows a rank, EMA with the dead-code
    reseed on), Adam's moments seeded alike, every rank with the same
    generator seeds; the ranks' parameters and metrics bit-identical, and
    held to a serial emulation here (each half's gradients averaged, the
    counts and sums summed, the candidates concatenated, one update):
    losses 1e-5, gradient norms 1e-4, parameters 1e-4 of their norm, the
    final model's code indices equal; (c) K1, K2 and K3 launched on every
    rank in every FRL step and K4 in every VQ-VAE step. Printed: each
    rank's step ms beside the plain step's on 6 rows alone, the gradient
    all-reduce's ms with gloo on one card and with NCCL at world size 1,
    and the phase's seconds;
20. the compact wire, K steps per block and the VQ-VAE config ladder,
    run after phase 19 (``wire_and_check``): (a) three CLI runs of
    ``configs/vae_v0.yaml`` at its full width (emb 128, hidden 128,
    codebook 256, batch 64) on a 256² legacy cube, 8 steps each from one
    seed: plain, ``wire_compact: true`` and the wire with
    ``steps_per_dispatch: 4``, which the CLI accepts and runs one step at a
    time (cuDNN deterministic for the three): the last two equal bit for
    bit in history and parameters, the wire within 2e-2
    of plain in train and validation ``loss_total`` (the JAX package's
    bound), K4 launched once a train and a validation step in each; (b)
    ``run_epoch`` of the v1 model on phase 14's cube, 2 steps with
    ``wire_compact=True`` and the step's ``wire_skip``, against the same
    epoch with the wire off from the same start: ``loss_total`` within
    2e-2, K1, K2 and K3 launched every step; one train batch assembled
    channel-major, encoded, copied and decoded on the card equal to the
    channel-last batch rounded to bfloat16 bit for bit, the categorical
    group, the masks and the windows exact; (c) ``configs/vae_evt_only.
    yaml``, ``vae_static_only.yaml`` and ``vae_full.yaml`` at their full
    widths, 4 CLI steps each on a 256² cube of the sources
    ``tests/test_config_ladder.py`` gives them: every metric finite, K4
    once a train and a validation step; (d) ``decode_wire_batch`` on the
    card equal to the same decode on the CPU, bit for bit, for the VQ-VAE
    batch with a uint16 id leaf added (ids up to 2**16 - 1) and the
    channel-major FRL batch. Printed: H2D bytes per batch
    plain and on the wire, ms per step of each VQ-VAE run and ladder rung,
    the FRL epochs' seconds and loader waits, the loader's seconds per
    batch channel-major against the channel-last stack;
21. the steps' FLOPs and MFU (``flops_and_check``): one FRL train step as
    phase 8 builds it (B 12) and one VQ-VAE train step as phase 12 builds
    it (``configs/vae_v0.yaml``, batch 64) counted on the card by
    ``utils.flops.step_flops``, each hand-written kernel by its declared
    cost; the FRL step at B 2 and the VQ-VAE step counted on the card and
    on this machine's CPU, which must agree to the FLOP, operator by
    operator. Printed: each step's GFLOP by operator, and its MFU
    (``utils.flops.mfu_fields``) over phase 8's and phase 12's median step
    times against the H100's dense peaks, with the card's name and power
    limit; the reference's implied MFU on its A40 at 1.1 s a batch.

``--profile-vq-core`` prints only phase 9's split of K4 by kernel;
``--profile-vq-assign`` K5's and K7's device time by kernel at the bench
shape and their times by CUDA events at three N.
``--profile-training`` builds the kernels and then, instead of phases 3-12,
runs three warm full training steps (every loss of ``DEFAULT_WEIGHTS``),
two timed and two under ``torch.profiler``, and prints the device's busy
time per step against the step's time without the profiler, the host
synchronisations per step with the operators that made them, the forward's
device time by stage of ``process_batch``, the kernels that took most of
the device's time and every kernel of this package, then the step's GFLOP
(``utils.flops.step_flops``) and its MFU over the step's time and over the
device's busy time; it prints no result lines.
``--profile-training-type-only`` profiles the same step with the three
type losses alone (the phase weights 0, as before the phase
curriculum starts). ``--profile-vqvae`` does the same for
20 VQ-VAE train steps, on a resident batch and with the batch's copy to the
device.

The line before the last is a JSON object ``{"kernels": [...]}`` with each
kernel's source, launches by main path (serving, the FRL training step,
the FRL training CLI and, for K1, the eval, clustering and diagnostics
tools and the encoder on the built cube; for the
VQ kernels the VQ-VAE's CLI run, the op called directly in its timed runs,
and the variant sweep; for K1-K4 the data-parallel ranks of phase 19; for
K1-K3 phase 20's wire epoch, for K4 its three wire runs and the ladder),
error, times, and its bound: the larger of its declared bytes
(every input read once, every output written once) over 3.35 TB/s and its
declared FLOPs over 67 TFLOP/s (float32 outside the tensor cores; 989
TFLOP/s where bfloat16 operands could use them), the H100's published
rates as ``utils/flops.BOUND_PEAK_FLOPS`` rounds them. The declared
cost is the kernel's ``*_cost`` function
(``ops.smoothing.bank_mix_cost`` and ``bank_mix_bwd_cost``,
``ops.scatter.scatter_add_rows_cost``, ``ops.vq.vq_core_cost`` and
``vq_assign_cost``, ``ops.vq_variants.assign_cost``), which is also the
FLOP formula of the kernel's ``torch.library`` op. The
script fails if any of the seven was launched no time on its path. The last
line is ``{"ok": true, "device": {...}}``. Without a CUDA device, or without
the rest of the repository beside it, the script exits non-zero and prints
no result. It imports ``torch`` and ``forest_tpu_torch`` only: nothing of
JAX and nothing of the JAX package ``forest_tpu``, whose host code the port
keeps its own copy of.
"""
from __future__ import annotations

import json
import pickle
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parent
KERNELS = {   # name -> (source in the repo, TPU kernel it replaces)
    "bank_mix_fwd": ("forest_tpu_torch/csrc/bank_mix_fwd.cu",
                     "forest_tpu/ops/smoothing.py:181"),     # _fwd_kernel
    "bank_mix_bwd": ("forest_tpu_torch/csrc/bank_mix_bwd.cu",
                     "forest_tpu/ops/smoothing.py:209"),     # _bwd_kernel
    "scatter_add_rows": ("forest_tpu_torch/csrc/scatter_add_rows.cu",
                         "forest_tpu/ops/scatter.py:95"),    # _scatter_kernel
    "vq_core": ("forest_tpu_torch/csrc/vq_assign.cu",
                "forest_tpu/ops/vq.py:92"),                  # _vq_kernel
    "vq_assign": ("forest_tpu_torch/csrc/vq_assign.cu",
                  "forest_tpu/ops/vq.py:228"),               # _vq_assign_kernel
    "vq_variant_rows": ("forest_tpu_torch/csrc/vq_variants.cu",
                        "scripts/bench_vq_variants.py:33"),  # _kernel
    "vq_variant_cols": ("forest_tpu_torch/csrc/vq_variants.cu",
                        "scripts/bench_vq_variants.py:76"),  # _kernel_t
}
# the .cu files behind KERNELS, one nvcc each (two kernels share a source)
LIBRARIES = ("bank_mix_fwd", "bank_mix_bwd", "scatter_add_rows", "vq_assign",
             "vq_variants")
# a blosc-LZ4 v2 cube written by the JAX package's cube_v2 writer
# (tests/torch_fixtures/make_blosc_lz4_v2.py): 64 x 64, chunks of 32 x 32
FIXTURE = "tests/torch_fixtures/blosc_lz4_v2"
FIXTURE_PATCH = 32
SERVE_SHAPE = (8, 256, 256, 48)
TRAIN_SHAPE = (12, 256, 256, 48)
# rows per sample through the scatter at the training shape: 300 anchors +
# 300 * 4 positive neighbours + the 512-pixel negative pool
SCATTER_SHAPE = (12, 2012, 65536, 48)     # B, N, R = H*W, C
SCATTER_ODD_SHAPE = (3, 77, 131, 5)
SCATTER_EXACT_SHAPE = (2, 300, 4099, 5)   # and four destinations in use
TRAIN_STEPS_WARM, TRAIN_STEPS_TIMED = 2, 5
# the VQ bench shape (bench.py, scripts/bench_vq_variants.py) and the VQ-VAE
# train step's (batch 64 of configs/vae_v0.yaml); odd shapes without padding
VQ_SHAPE = (131072, 128, 256)             # N, D, K
VQ_STEP_SHAPE = (64, 128, 256)
VQ_ODD_SHAPES = ((333, 24, 17), (5, 7, 3))
VQ_TILES = (512, 1024, 2048, 4096)        # the TPU sweep's tile values
# the edges of vq_core's one-launch path (N <= 128) and a cut between the
# statistics pass's segments (256 rows)
VQ_EDGE_N = (1, 63, 65, 127, 128, 129, 845)
# Kernel vs plain version of the argmin, stated in float64: the kernel sums
# the 128 products of a distance in another order than torch.matmul, so a row
# whose two best codes lie within float32 rounding of each other may get
# either. For every row the code the kernel chose must be within
# VQ_TOL_ULPS float32 ulps of max |d| of the best distance.
VQ_TOL_ULPS = 64
VQ_SUMS_REL_BOUND = 1e-5      # sums, sum(q * x): relative to max |value|
VQ_TRAIN_EPOCHS, VQ_TRAIN_STEPS = 2, 100
VQ_TRAIN_LOSS_REL_BOUND = 1e-6
ODD_SHAPE = (2, 33, 37, 5)
# K2 walks strips of 32 columns in segments of 64 rows: these cross both
# borders with a ragged last strip, with C = 48 (compiled in), with an odd C
# (the scalar path) and with another even C (the vector path, C at run time)
BWD_BORDER_SHAPES = ((1, 130, 70, 48), (2, 70, 37, 5), (1, 70, 40, 8))
# K1 walks strips of 32 columns in segments of 32 rows: the same three paths
FWD_BORDER_SHAPES = ((1, 70, 37, 48), (1, 40, 70, 8), (2, 40, 37, 5))
RANK, COARSE_DILATION, NUM_DIRECTIONS = 4, 3, 4
T_STEPS = 15          # data.cube_v2.synthetic_bindings' annual window
SEED = 0
# Kernel vs plain version. float32: the same f32 sums in another order.
# bfloat16: both round an f32 result once, so they differ by at most one
# bf16 ulp, 2^-7 of the largest magnitude.
F32_BOUND = 1e-5
BF16_ULP = 2.0 ** -7
# Served z_type / z_phase with the kernel vs with the plain version: the
# smoothing block runs in bf16, so one-ulp differences of the bank pass
# through the bf16 gate convs; bound on max |diff| / max |ref|.
SERVE_REL_BOUND = 2.0 ** -5
# K3 vs index_add_ on the card: float32 sums of rows that share a
# destination; the kernel adds them in ascending order, index_add_'s atomics
# in any (at most a few rows per destination here).
SCATTER_BOUND = 1e-5
# One training step with the kernels vs with their plain versions, same
# weights and draws: the bf16 smoothing block rounds the bank's output and
# its gradients to bf16 in both, so the two differ by one bf16 ulp at a few
# elements in a million; over 3,600 anchors and 174,072 parameters that
# left the type-pathway step's loss and global gradient norm apart by ~1e-7
# and ~1e-6 relative (as measured on an H100; the full step's, 4-7x larger,
# came out equal to the last bit); the bounds leave a 100-fold margin.
STEP_LOSS_REL_BOUND = 1e-5
STEP_GNORM_REL_BOUND = 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, runs: int = 20, warmup: int = 3) -> float:
    """Median of CUDA-event timings of single calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def kernel_inputs(shape, dtype, generator):
    import torch
    b, h, w, c = shape
    dev = "cuda"
    x = torch.randn(b, h, w, c, device=dev, generator=generator)
    a_w = torch.softmax(torch.randn(b, h, w, 2 * NUM_DIRECTIONS, RANK,
                                    device=dev, generator=generator), 3)
    b_w = torch.softmax(torch.randn(b, h, w, c, RANK, device=dev,
                                    generator=generator), 4)
    return (x.to(dtype).contiguous(), a_w.to(dtype).contiguous(),
            b_w.to(dtype).contiguous())


def bound_ms(cost, peak: str = "f32"):
    """-> (ms, "bytes" | "operations"): the least time the card could take
    for one call of a kernel's declared cost (``utils/flops.KernelCost``,
    from the kernel's ``*_cost`` function): its bytes over 3.35 TB/s
    against its FLOPs over the float32 or the bfloat16 (``peak`` "f32" or
    "bf16") rate of ``utils/flops.BOUND_PEAK_FLOPS``
    (``utils/flops.bound_s``)."""
    from forest_tpu_torch.utils.flops import BOUND_PEAK_FLOPS, bound_s
    seconds, by = bound_s(cost, BOUND_PEAK_FLOPS[peak])
    return seconds * 1e3, by


def _bound(dtype, ref_max: float) -> float:
    import torch
    return F32_BOUND if dtype == torch.float32 else \
        BF16_ULP * max(1.0, ref_max)


def check_fwd(shape, dtype, generator, timed: bool) -> dict:
    import torch
    from forest_tpu_torch.ops import smoothing as sm
    x, a_w, b_w = kernel_inputs(shape, dtype, generator)
    kw = dict(num_directions=NUM_DIRECTIONS, coarse_dilation=COARSE_DILATION)
    out = sm.bank_mix(x, a_w, b_w, **kw)
    again = sm.bank_mix(x, a_w, b_w, **kw)
    torch.cuda.synchronize()
    ref = sm.bank_mix_reference(x, a_w, b_w, **kw)
    res = {"kernel": "bank_mix_fwd", "shape": list(shape),
           "dtype": str(dtype).replace("torch.", ""),
           "max_abs_err": (out.float() - ref.float()).abs().max().item(),
           "bound": _bound(dtype, ref.float().abs().max().item()),
           "runs_bit_identical": bool(torch.equal(out, again))}
    del again
    del ref
    if timed:
        res["bound_ms"], res["bound_by"] = bound_ms(sm.bank_mix_cost(
            x.shape, RANK, NUM_DIRECTIONS, x.element_size()))
        res["ms"] = cuda_ms(lambda: sm.bank_mix(x, a_w, b_w, **kw))
        res["plain_ms"] = cuda_ms(
            lambda: sm.bank_mix_reference(x, a_w, b_w, **kw), runs=5)
    log(f"kernel check {json.dumps(res)}")
    if not (res["max_abs_err"] <= res["bound"]
            and res["runs_bit_identical"]):
        raise AssertionError(f"bank_mix_fwd disagrees with its plain "
                             f"version or with itself: {res}")
    return res


def check_bwd(shape, dtype, generator, timed: bool) -> dict:
    import torch
    from forest_tpu_torch.ops import smoothing as sm
    x, a_w, b_w = kernel_inputs(shape, dtype, generator)
    g = torch.randn(shape, device="cuda", generator=generator).to(dtype)
    kw = dict(num_directions=NUM_DIRECTIONS, coarse_dilation=COARSE_DILATION)
    got = sm.bank_mix_bwd(x, a_w, b_w, g, **kw)
    torch.cuda.synchronize()
    ref = sm.bank_mix_bwd_reference(x, a_w, b_w, g, **kw)
    res = {"kernel": "bank_mix_bwd", "shape": list(shape),
           "dtype": str(dtype).replace("torch.", ""), "max_abs_err": 0.0}
    ok = True
    for name, u, v in zip(("dx", "dA", "dB"), got, ref):
        err = (u.float() - v.float()).abs().max().item()
        bound = _bound(dtype, v.float().abs().max().item())
        res[name] = {"max_abs_err": err, "bound": bound}
        res["max_abs_err"] = max(res["max_abs_err"], err)
        ok = ok and err <= bound
    del ref
    if timed:
        res["bound_ms"], res["bound_by"] = bound_ms(sm.bank_mix_bwd_cost(
            x.shape, RANK, NUM_DIRECTIONS, x.element_size()))
        res["ms"] = cuda_ms(lambda: sm.bank_mix_bwd(x, a_w, b_w, g, **kw))
        res["plain_ms"] = cuda_ms(
            lambda: sm.bank_mix_bwd_reference(x, a_w, b_w, g, **kw), runs=3,
            warmup=1)
    log(f"kernel check {json.dumps(res)}")
    if not ok:
        raise AssertionError(f"bank_mix_bwd disagrees with its plain "
                             f"version: {res}")
    return res


def check_scatter(shape, generator, timed: bool) -> dict:
    import torch
    from forest_tpu_torch.ops import scatter as sc
    b, n, r, c = shape
    dz = torch.randn(b, n, c, device="cuda", generator=generator)
    idx = torch.randint(0, r, (b, n), device="cuda", generator=generator)
    idx[:, :n // 4] = idx[:, n // 4:2 * (n // 4)]      # duplicated rows
    out = sc.scatter_add_rows(dz, idx, r)
    again = sc.scatter_add_rows(dz, idx.int(), r, check_index=False)
    torch.cuda.synchronize()
    ref = sc.scatter_add_rows_reference(dz, idx, r)
    res = {"kernel": "scatter_add_rows", "shape": list(shape),
           "dtype": "float32",
           "max_abs_err": (out - ref).abs().max().item(),
           "bound": SCATTER_BOUND,
           "runs_bit_identical": bool(torch.equal(out, again))}
    del out, again, ref
    if timed:
        # the indices counted as int32, as the bound has always counted them
        res["bound_ms"], res["bound_by"] = bound_ms(
            sc.scatter_add_rows_cost(dz.shape, r))
        # the form the training step runs, then the public form, whose
        # check of the device's flag synchronises with the host
        res["ms"] = cuda_ms(lambda: sc.scatter_add_rows(
            dz, idx, r, check_index=False))
        res["checked_ms"] = cuda_ms(lambda: sc.scatter_add_rows(dz, idx, r))
        res["plain_ms"] = cuda_ms(
            lambda: sc.scatter_add_rows_reference(dz, idx, r))
        flat = (idx + torch.arange(b, device="cuda")[:, None] * r
                ).reshape(-1)
        rows = dz.reshape(-1, c)
        res["library_ms"] = cuda_ms(
            lambda: torch.zeros(b * r, c, device="cuda").index_add_(
                0, flat, rows))
        # back to back, the host's enqueueing hidden behind the device
        for key, fn in (
                ("back_to_back_ms", lambda: sc.scatter_add_rows(
                    dz, idx, r, check_index=False)),
                ("library_back_to_back_ms", lambda: torch.zeros(
                    b * r, c, device="cuda").index_add_(0, flat, rows))):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            fn()
            torch.cuda.synchronize()
            start.record()
            for _ in range(50):
                fn()
            end.record()
            end.synchronize()
            res[key] = start.elapsed_time(end) / 50
    log(f"kernel check {json.dumps(res)}")
    if not (res["max_abs_err"] <= SCATTER_BOUND
            and res["runs_bit_identical"]):
        raise AssertionError(f"scatter_add_rows disagrees with its plain "
                             f"version or with itself: {res}")
    return res


def check_scatter_exact(generator) -> dict:
    """K3 where every sum is exact in float32: small integers, ~75 rows on
    each of four destinations per sample. The kernel must equal its plain
    version bit for bit. Then with indices out of range: the public form
    raises, the unchecked form leaves those rows out."""
    import torch
    from forest_tpu_torch.ops import scatter as sc
    b, n, r, c = SCATTER_EXACT_SHAPE
    dz = torch.randint(-3, 4, (b, n, c), device="cuda",
                       generator=generator).float()
    dest = torch.tensor([5, 6, 2050, r - 1], device="cuda")
    idx = dest[torch.randint(0, 4, (b, n), device="cuda",
                             generator=generator)]
    out = sc.scatter_add_rows(dz, idx, r)
    ref = sc.scatter_add_rows_reference(dz, idx, r)
    res = {"kernel": "scatter_add_rows", "shape": [b, n, r, c],
           "exact": bool(torch.equal(out, ref)),
           "rows_per_destination": n / 4}
    bad = idx.clone()
    bad[0, 3], bad[1, 7], bad[1, n - 1] = r, -1, r + 12345
    try:
        sc.scatter_add_rows(dz, bad, r)
        res["bad_index_raises"] = False
    except IndexError:
        res["bad_index_raises"] = True
    skipped = sc.scatter_add_rows(dz, bad, r, check_index=False)
    in_range = (bad >= 0) & (bad < r)
    kept = sc.scatter_add_rows_reference(
        dz * in_range[:, :, None], torch.where(in_range, bad, 0), r)
    torch.cuda.synchronize()
    res["bad_rows_left_out"] = bool(torch.equal(skipped, kept))
    log(f"kernel check {json.dumps(res)}")
    if not (res["exact"] and res["bad_index_raises"]
            and res["bad_rows_left_out"]):
        raise AssertionError(f"scatter_add_rows, exact data: {res}")
    return res


def argmin_rule(x, c, idx, c2_from=None) -> dict:
    """The float64 rule: d64 = ||x||^2 - 2 x.c^T + ||c2_from||^2 on the
    operands as the kernel multiplied them; every row's chosen code must be
    within VQ_TOL_ULPS * 2^-23 * max |d64| of the row's best."""
    import torch
    x64, c64 = x.double(), c.double()
    c2 = ((c if c2_from is None else c2_from).double() ** 2).sum(-1)
    d64 = (x64 * x64).sum(-1, keepdim=True) - 2.0 * (x64 @ c64.t()) + c2
    best = d64.min(dim=1).values
    picked = d64.gather(1, idx.long()[:, None])[:, 0]
    tol = VQ_TOL_ULPS * 2.0 ** -23 * d64.abs().max().item()
    excess = (picked - best).max().item()
    return {"excess": excess, "tol": tol, "ok": bool(excess <= tol)}


def vq_inputs(shape, generator):
    import torch
    n, d, k = shape
    return (torch.randn(n, d, device="cuda", generator=generator),
            torch.randn(k, d, device="cuda", generator=generator))


def integer_inputs(generator, n=4096, d=32, k=64):
    """Small integers, the upper half of the codebook a copy of the lower:
    every product and sum is exact in float32 in any order, so a kernel and
    its plain version must agree bit for bit, through many exact ties."""
    import torch
    x = torch.randint(-2, 3, (n, d), device="cuda",
                      generator=generator).float()
    c = torch.randint(-2, 3, (k // 2, d), device="cuda",
                      generator=generator).float()
    return x, torch.cat([c, c])


def nan_inputs(generator, shape=VQ_ODD_SHAPES[0]):
    """Row 3 of x and code 5 all NaN, one more NaN in row 7 of x."""
    x, c = vq_inputs(shape, generator)
    x[3] = float("nan")
    x[7, 2] = float("nan")
    c[5] = float("nan")
    return x, c


def check_core_outputs(x, c, got, with_qx: bool) -> dict:
    """vq_core's outputs against its plain version on the same inputs:
    idx by the float64 rule, with the number of rows where the two differ;
    q, counts, sums and sum(q * x) against the plain formulas evaluated on
    the kernel's own idx (so that a row which legitimately took the other of
    two near-equal codes does not count against the sums)."""
    import torch
    from forest_tpu_torch.ops import vq
    idx, q, counts, sums = got[:4]
    k = c.shape[0]
    ref = vq.vq_core_reference(x, c, with_qx)
    res = {"shape": [x.shape[0], x.shape[1], k], "dtype": "float32",
           "idx_rule": argmin_rule(x, c, idx),
           "idx_mismatch_rows": int((idx != ref[0]).sum().item())}
    il = idx.long()
    exp_sums = torch.zeros_like(c).index_add_(0, il, x)
    scale = max(exp_sums.abs().max().item(), 1e-30)
    res["q_exact"] = bool(torch.equal(q, c.index_select(0, il)))
    res["counts_exact"] = bool(torch.equal(
        counts, torch.bincount(il, minlength=k).float()))
    res["max_abs_err"] = (sums - exp_sums).abs().max().item()
    res["sums_rel_err"] = res["max_abs_err"] / scale
    ok = (res["idx_rule"]["ok"] and res["q_exact"] and res["counts_exact"]
          and res["sums_rel_err"] <= VQ_SUMS_REL_BOUND
          and int(idx.min()) >= 0 and int(idx.max()) < k)
    if with_qx:
        exp_qx = torch.sum(q.double() * x.double()).item()
        res["qx_rel_err"] = abs(got[4].item() - exp_qx) / max(abs(exp_qx),
                                                             1e-30)
        ok = ok and res["qx_rel_err"] <= VQ_SUMS_REL_BOUND
    res["ok"] = bool(ok)
    return res


def check_vq_core(generator) -> dict:
    """Phase 9: K4 against its plain version."""
    import torch
    from forest_tpu_torch.ops import vq
    x, c = vq_inputs(VQ_SHAPE, generator)
    n, d, k = VQ_SHAPE
    runs = [vq.vq_core(x, c, with_qx=True) for _ in range(2)]
    without_qx = vq.vq_core(x, c)       # the kernel without sum(q * x)
    assign_idx = vq.vq_assign(x, c)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(*runs)) and all(
        torch.equal(a, b) for a, b in zip(without_qx, runs[0]))
    res = check_core_outputs(x, c, runs[0], True)
    # the parity gate of the JAX package: the same function on the CPU
    cpu_idx = vq.vq_core_reference(x.cpu(), c.cpu())[0]
    res.update(kernel="vq_core", two_runs_bit_identical=bool(same),
               idx_equals_vq_assign=bool(torch.equal(runs[0][0],
                                                     assign_idx)),
               idx_mismatch_rows_vs_cpu=int(
                   (runs[0][0].cpu() != cpu_idx).sum().item()))
    ok = res["ok"] and same and res["idx_equals_vq_assign"]
    edges = [(m, d, k) for m in VQ_EDGE_N]
    for shape in (VQ_STEP_SHAPE,) + tuple(edges) + VQ_ODD_SHAPES:
        xs, cs = vq_inputs(shape, generator)
        got = vq.vq_core(xs, cs, True)
        again = vq.vq_core(xs, cs, True)
        small = check_core_outputs(xs, cs, got, True)
        small.update(
            runs_bit_identical=all(torch.equal(a, b)
                                   for a, b in zip(got, again)),
            idx_equals_vq_assign=bool(torch.equal(got[0],
                                                  vq.vq_assign(xs, cs))))
        log(f"kernel check {json.dumps(dict(small, kernel='vq_core'))}")
        ok = ok and small["ok"] and small["idx_mismatch_rows"] == 0 and \
            small["runs_bit_identical"] and small["idx_equals_vq_assign"]

    xn, cn = nan_inputs(generator)                     # the NaN rule
    got, ref = vq.vq_core(xn, cn), vq.vq_core_reference(xn, cn)
    nan_ok = (torch.equal(got[0], ref[0]) and int(got[0][3]) == 0
              and not bool((got[0] == 5).any())
              and torch.equal(got[1][3], cn[0])
              and torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2])
              and float(got[2].sum()) == xn.shape[0])
    xi, ci = integer_inputs(generator)                 # exact ties
    got, ref = vq.vq_core(xi, ci, True), vq.vq_core_reference(xi, ci, True)
    ties_ok = all(torch.equal(a, b) for a, b in zip(got, ref)) and \
        int(got[0].max()) < ci.shape[0] // 2
    empty = vq.vq_core(x[:0], c)
    empty_ok = empty[0].shape == (0,) and empty[1].shape == (0, d) and \
        float(empty[2].sum()) == 0.0
    res.update(nan_rule_ok=bool(nan_ok), exact_ties_ok=bool(ties_ok),
               empty_ok=bool(empty_ok))
    ok = ok and nan_ok and ties_ok and empty_ok

    res["bound_ms"], res["bound_by"] = bound_ms(vq.vq_core_cost(n, d, k))
    vq.vq_core.launches = 0       # the timed runs: the op called directly
    res["ms"] = cuda_ms(lambda: vq.vq_core(x, c))
    res["with_qx_ms"] = cuda_ms(lambda: vq.vq_core(x, c, with_qx=True))
    res["path_launches"] = vq.vq_core.launches
    res["plain_ms"] = cuda_ms(lambda: vq.vq_core_reference(x, c), runs=5)

    def composition():      # PyTorch calls for the same outputs, TF32 off
        c2 = (c * c).sum(-1)
        i = torch.addmm(c2, x, c.t(), alpha=-2.0).argmin(1)
        return (i, c[i], torch.bincount(i, minlength=k),
                torch.zeros_like(c).index_add_(0, i, x))

    res["library_ms"] = cuda_ms(composition)
    res["library_is"] = "a composition: addmm, argmin, gather, bincount, " \
                        "index_add_"
    res["split"] = vq_core_split(generator)
    step = res["split"]["x".join(map(str, VQ_STEP_SHAPE))]
    res["launches_per_call"] = {key: v["launches_per_call"]
                                for key, v in res["split"].items()}
    res["step_shape_device_ms"] = step["device_ms_per_call"]
    res["step_shape_host_ms"] = step["host_ms_call_to_return"]
    for key, launches in res["launches_per_call"].items():
        rows, _, codes = map(int, key.split("x"))
        if launches != vq.vq_core_launches(rows, codes):
            ok = False
    log(f"kernel check {json.dumps(res)}")
    if not ok:
        raise AssertionError(f"vq_core disagrees with its plain version: "
                             f"{res}")
    return res


def check_vq_assign(generator) -> dict:
    """Phase 10: K5, float32 (the resident product: indices equal K4's)
    and with bfloat16 operands (the tensor cores: the float64 rule, two runs
    bit for bit, integer inputs exact); the path each shape takes."""
    import torch
    from forest_tpu_torch.ops import vq
    x, c = vq_inputs(VQ_SHAPE, generator)
    n, d, k = VQ_SHAPE
    out = {}
    for bf16 in (False, True):
        idx = vq.vq_assign(x, c, mxu_bf16=bf16)
        path = vq.vq_assign.last_path
        again = vq.vq_assign(x, c, mxu_bf16=bf16)
        torch.cuda.synchronize()
        ref = vq.vq_assign_reference(x, c, mxu_bf16=bf16)
        xp, cp = (x.bfloat16(), c.bfloat16()) if bf16 else (x, c)
        res = {"kernel": "vq_assign", "shape": list(VQ_SHAPE),
               "dtype": "float32, bf16 operands" if bf16 else "float32",
               "path": path,
               "idx_rule": argmin_rule(xp, cp, idx, c2_from=c),
               "idx_mismatch_rows": int((idx != ref).sum().item()),
               "two_runs_bit_identical": bool(torch.equal(idx, again))}
        ok = res["idx_rule"]["ok"] and res["two_runs_bit_identical"] and \
            path == ("mma" if bf16 else "resident")
        paths = {"x".join(map(str, VQ_SHAPE)): path}
        if not bf16:
            res["equals_vq_core_idx"] = bool(torch.equal(
                idx, vq.vq_core(x, c)[0]))
            ok = ok and res["equals_vq_core_idx"]
        for shape in (VQ_STEP_SHAPE,) + VQ_ODD_SHAPES:
            xs, cs = vq_inputs(shape, generator)
            xsp, csp = (xs.bfloat16(), cs.bfloat16()) if bf16 else (xs, cs)
            got = vq.vq_assign(xs, cs, mxu_bf16=bf16)
            key = "x".join(map(str, shape))
            paths[key] = vq.vq_assign.last_path
            ok = ok and argmin_rule(xsp, csp, got, c2_from=cs)["ok"] and \
                paths[key] == vq.vq_assign_path(*shape, mxu_bf16=bf16) and \
                torch.equal(got, vq.vq_assign(xs, cs, mxu_bf16=bf16))
            if not bf16:     # K5 float32 = K4 at every card shape
                same = bool(torch.equal(got, vq.vq_core(xs, cs)[0]))
                res[f"equals_vq_core_idx_{key}"] = same
                ok = ok and same
        res["paths"] = paths
        xn, cn = nan_inputs(generator)
        got = vq.vq_assign(xn, cn, mxu_bf16=bf16)
        res["nan_rule_ok"] = bool(
            torch.equal(got, vq.vq_assign_reference(xn, cn, mxu_bf16=bf16))
            and int(got[3]) == 0 and not bool((got == 5).any()))
        xi, ci = integer_inputs(generator)
        res["exact_ties_ok"] = bool(torch.equal(
            vq.vq_assign(xi, ci, mxu_bf16=bf16),
            vq.vq_assign_reference(xi, ci, mxu_bf16=bf16)))
        ok = ok and res["nan_rule_ok"] and res["exact_ties_ok"] and \
            vq.vq_assign(x[:0], c).shape == (0,)
        # bf16 operands may use the tensor cores
        res["bound_ms"], res["bound_by"] = bound_ms(
            vq.vq_assign_cost(n, d, k, bf16), "bf16" if bf16 else "f32")
        res["max_abs_err"] = max(res["idx_rule"]["excess"], 0.0)
        vq.vq_assign.launches = 0     # the timed runs, as for vq_core
        res["ms"] = cuda_ms(lambda: vq.vq_assign(x, c, mxu_bf16=bf16))
        res["path_launches"] = vq.vq_assign.launches
        res["plain_ms"] = cuda_ms(
            lambda: vq.vq_assign_reference(x, c, mxu_bf16=bf16), runs=5)
        res["library_ms"] = cuda_ms(lambda: torch.addmm(
            (c * c).sum(-1), x, c.t(), alpha=-2.0).argmin(1))
        res["library_is"] = "a composition: addmm, argmin"
        log(f"kernel check {json.dumps(res)}")
        if not ok:
            raise AssertionError(f"vq_assign disagrees with its plain "
                                 f"version: {res}")
        out["bf16" if bf16 else "f32"] = res
    return out


def check_variants(generator, iters: int = 5) -> dict:
    """Phase 11: K6 and K7, each knob against its plain version at the sweep's
    shape, then the sweep itself (``vq_variants.main``) for the times."""
    import torch
    from forest_tpu_torch.ops import vq_variants as vv
    x, c = vq_inputs(VQ_SHAPE, generator)
    xt = x.t().contiguous()
    n, d, k = VQ_SHAPE
    f32, bf16 = torch.float32, torch.bfloat16
    checks = {"vq_variant_rows": [], "vq_variant_cols": []}

    def hold(kernel, name, fn, xin, mxu, io, plain):
        idx = fn(xin, c)
        torch.cuda.synchronize()
        cf = c.to(io)
        xf = x.to(io)
        xp, cp = (xf.bfloat16(), cf.bfloat16()) if mxu else (xf, cf)
        rule = argmin_rule(xp, cp, idx, c2_from=cf)
        res = {"variant": name, "idx_rule": rule,
               "idx_mismatch_rows": int((idx != plain(xin, c)).sum().item())}
        checks[kernel].append(res)
        log(f"kernel check {json.dumps(dict(res, kernel=kernel))}")
        if not rule["ok"]:
            raise AssertionError(f"{kernel} {name} disagrees with its "
                                 f"plain version: {res}")

    for name, mxu, io in (("f32", False, f32), ("bf16 operands", True, f32),
                          ("bf16 io", True, bf16)):
        hold("vq_variant_rows", name, vv.make_assign(512, mxu, io), x, mxu,
             io, lambda a, b, m=mxu, t=io: vv.assign_reference(a, b, m, t))
        for pre in (True, False):
            hold("vq_variant_cols", f"{name}, pre_transposed={pre}",
                 vv.make_assign_t(2048, mxu, io, pre), xt if pre else x, mxu,
                 io, lambda a, b, m=mxu, t=io, p=pre:
                 vv.assign_t_reference(a, b, m, t, p))
    # argmin=False writes the truncated row minimum: a float32 rounding of
    # the minimum next to a whole number may move it by one
    for name, mxu, io in (("f32", False, f32), ("bf16 operands", True, f32),
                          ("bf16 io", True, bf16)):
        got = vv.make_assign(512, mxu, io, argmin=False)(x, c)
        path = vv.make_assign.last_path
        ref = vv.assign_reference(x, c, mxu, io, argmin=False)
        diff = (got.long() - ref.long()).abs()
        res = {"variant": f"{name}, argmin=False", "path": path,
               "max_abs_diff": int(diff.max().item()),
               "rows_differing": int((diff != 0).sum().item())}
        checks["vq_variant_rows"].append(res)
        log(f"kernel check {json.dumps(dict(res, kernel='vq_variant_rows'))}")
        if res["max_abs_diff"] > 1 or res["rows_differing"] > n // 1000 \
                or path != ("mma" if mxu else "resident"):
            raise AssertionError(f"vq_variant_rows argmin=False: {res}")
    xi, ci = integer_inputs(generator)
    if not (torch.equal(vv.make_assign(128, False)(xi, ci),
                        vv.assign_reference(xi, ci))
            and torch.equal(vv.make_assign_t(128, False)(xi, ci),
                            vv.assign_t_reference(xi, ci))):
        raise AssertionError("the variants break an exact tie differently "
                             "from their plain versions")
    for shape in VQ_ODD_SHAPES:
        xs, cs = vq_inputs(shape, generator)
        for fn in (vv.make_assign(128, False), vv.make_assign_t(256, False)):
            if not argmin_rule(xs, cs, fn(xs, cs))["ok"]:
                raise AssertionError(f"a variant is wrong at {shape}")

    # the TPU's tile has no say on the card: every tile, the same indices;
    # K6 and K7 float32 = K5 float32 on finite data, K6 with bfloat16
    # operands = K5 bfloat16 (the same rounding and products; with bfloat16
    # storage ||C||^2 comes from the stored codebook, so only the rule holds)
    from forest_tpu_torch.ops import vq
    k5 = {False: vq.vq_assign(x, c), True: vq.vq_assign(x, c, mxu_bf16=True)}
    tiles = {"vq_variant_rows": {}, "vq_variant_cols": {}}
    for kernel, make, xin in (("vq_variant_rows", vv.make_assign, x),
                              ("vq_variant_cols", vv.make_assign_t, xt)):
        for name, mxu, io in (("f32", False, f32),
                              ("bf16 operands", True, f32),
                              ("bf16 io", True, bf16)):
            got = [(make(tile, mxu, io, True) if make is vv.make_assign_t
                    else make(tile, mxu, io))(xin, c) for tile in VQ_TILES]
            path = make.last_path
            same = all(torch.equal(got[0], g) for g in got[1:])
            res = {"path": path, "same_indices_at_every_tile": same}
            if not same or path != ("mma" if mxu else "resident"):
                raise AssertionError(f"{kernel} {name}: {res}")
            if io == f32 and (kernel == "vq_variant_rows" or not mxu):
                res["equals_vq_assign"] = bool(torch.equal(got[0], k5[mxu]))
                if not res["equals_vq_assign"]:
                    raise AssertionError(f"{kernel} {name} indices differ "
                                         f"from vq_assign's")
            tiles[kernel][name] = res
        log("kernel check "
            + json.dumps({"kernel": kernel, "tiles": tiles[kernel]}))

    vv.make_assign.launches = vv.make_assign_t.launches = 0
    times = vv.main(["--iters", str(iters)])           # the sweep
    swept = {"vq_variant_rows": vv.make_assign.launches,
             "vq_variant_cols": vv.make_assign_t.launches}
    lib = times["torch (matmul + argmin)"] / 1e3
    bound, bound_by = bound_ms(vv.assign_cost(n, d, k))
    common = {"shape": list(VQ_SHAPE), "dtype": "float32",
              "bound_ms": bound, "bound_by": bound_by,
              "library_ms": lib,
              "library_is": "a composition: matmul, argmin",
              "sweep_us": times}
    rows = dict(common, ms=times["kernel row-major f32 tile=512 (ref)"] / 1e3,
                bf16_mxu_ms=cuda_ms(lambda: vv.make_assign(512, True)(x, c)),
                bf16_io_ms=cuda_ms(
                    lambda: vv.make_assign(512, True, bf16)(x, c)),
                tiles=tiles["vq_variant_rows"],
                path_launches=swept["vq_variant_rows"],
                plain_ms=cuda_ms(lambda: vv.assign_reference(x, c), runs=5),
                max_abs_err=max(0.0, max(
                    r["idx_rule"]["excess"]
                    for r in checks["vq_variant_rows"] if "idx_rule" in r)),
                checks=checks["vq_variant_rows"])
    cols = dict(common, ms=times["kernelT f32     tileT=512 (pre-T)"] / 1e3,
                ms_by_tile={
                    tile: times[f"kernelT f32     tileT={tile} (pre-T)"] / 1e3
                    for tile in VQ_TILES},
                bf16_mxu_ms_by_tile={
                    tile: times[f"kernelT bf16-mxu tileT={tile} (pre-T)"]
                    / 1e3 for tile in VQ_TILES},
                tiles=tiles["vq_variant_cols"],
                path_launches=swept["vq_variant_cols"],
                plain_ms=cuda_ms(
                    lambda: vv.assign_t_reference(xt, c, pre_transposed=True),
                    runs=5),
                max_abs_err=max(0.0, max(
                    r["idx_rule"]["excess"]
                    for r in checks["vq_variant_cols"])),
                checks=checks["vq_variant_cols"])
    return {"vq_variant_rows": rows, "vq_variant_cols": cols}


def write_checkpoint(tmp: Path):
    """v1 model with seeded weights -> flax-layout checkpoint, bindings YAML
    and stats JSON in ``tmp``. Returns (checkpoint, bindings path)."""
    import torch
    import yaml

    from forest_tpu_torch.data import (parse_bindings, synthetic_bindings,
                                       synthetic_feature_stats)
    from forest_tpu_torch.models import representation as rep
    from forest_tpu_torch.training.checkpointing import save_state
    from forest_tpu_torch.utils.flax_bridge import params_to_flax

    cfg = yaml.safe_load((ROOT / "configs/frl_repr_model_v1.yaml")
                         .read_text())
    raw = synthetic_bindings(tmp / "cube.zarr", tmp / "stats.json")
    bindings = parse_bindings(raw)
    type_in = len(bindings.get_feature("type_encoder_input").channels)
    phase_in = len(bindings.get_feature("phase_ccdc").channels)
    model = rep.from_config(cfg, type_in, phase_in)
    rep.init_parameters(model, torch.Generator().manual_seed(SEED))
    ckpt = tmp / "encoder_v1.msgpack"
    save_state(ckpt, {"params": params_to_flax(model.state_dict())},
               {"model_config": rep.model_config_dict(model),
                "type_in_channels": type_in, "phase_in_channels": phase_in})
    (tmp / "stats.json").write_text(json.dumps(
        synthetic_feature_stats(bindings)))
    bpath = tmp / "bindings.yaml"
    bpath.write_text(yaml.safe_dump(raw))
    log(f"checkpoint: v1 config, type_in={type_in} phase_in={phase_in} "
        f"T={T_STEPS}, {sum(p.numel() for p in model.parameters())} params")
    return ckpt, bpath


def make_patches(n: int, hw: int):
    import numpy as np

    from forest_tpu_torch.data import synthetic_frl_batch
    batch = synthetic_frl_batch(np.random.default_rng(SEED), b=n, hw=hw,
                                t=T_STEPS)
    return [{k: v[i] for k, v in batch.items()} for i in range(n)]


def post(url: str, body: bytes):
    from forest_tpu_torch.serving import unpack_npz
    t0 = time.perf_counter()
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=600) as resp:
        out = unpack_npz(resp.read())
    return out, (time.perf_counter() - t0) * 1e3


def burst(base: str, bodies, phases):
    """POST all bodies at once from threads; -> (outputs, latencies ms,
    wall ms)."""
    results = [None] * len(bodies)
    errors = []

    def one(i):
        try:
            q = "?phase=1" if phases[i] else ""
            results[i] = post(f"{base}/v1/encode{q}", bodies[i])
        except Exception as e:  # reported below, fails the phase
            errors.append(e)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(bodies))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(900)
    wall = (time.perf_counter() - t0) * 1e3
    if errors or any(r is None for r in results):
        raise RuntimeError(f"requests failed: {errors}")
    return [r[0] for r in results], [r[1] for r in results], wall


def serve_and_check(ckpt: Path, bpath: Path, patches,
                    device: str = "cuda") -> dict:
    import numpy as np

    from forest_tpu_torch.serving import EncoderService, make_server, pack_npz

    svc = EncoderService(ckpt, bpath, device=device, max_batch=8)
    srv = make_server(svc, "127.0.0.1", 0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    n = len(patches)
    try:
        bodies = [pack_npz(p) for p in patches]
        type_only = [False] * n
        mixed = [i % 2 == 1 for i in range(n)]
        reset_launches()
        _, warm_ms, _ = burst(base, bodies[:1], [True])  # first use
        outs, lat_t, wall_t = burst(base, bodies, type_only)
        outs_m, lat_m, wall_m = burst(base, bodies, mixed)
        launches = read_launches()["bank_mix_fwd"]
        batches = svc.batches_run
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(30)
        svc.close()
    log(f"served {2 * n + 1} requests in {batches} batches, "
        f"kernel launches {launches}")
    if launches <= 0:
        raise AssertionError("serving never launched bank_mix_fwd")
    hw = patches[0]["static"].shape[0]
    for i, o in enumerate(outs + outs_m):
        want = {"z_type": (hw, hw, 48)}
        if i >= n and mixed[i - n]:
            want["z_phase"] = (T_STEPS, hw, hw, 8)
        got = {k: tuple(v.shape) for k, v in o.items()}
        if got != want:
            raise AssertionError(f"response {i}: shapes {got} != {want}")
        if not all(np.isfinite(v).all() for v in o.values()):
            raise AssertionError(f"response {i}: non-finite values")
    return {"launches": launches, "batches_run": batches,
            "first_request_ms": warm_ms[0],
            "burst_type_only": {"requests": n, "wall_ms": wall_t,
                                "latency_ms_median": sorted(lat_t)[n // 2],
                                "latency_ms_max": max(lat_t)},
            "burst_mixed_phase": {"requests": n, "wall_ms": wall_m,
                                  "latency_ms_median": sorted(lat_m)[n // 2],
                                  "latency_ms_max": max(lat_m)},
            "checked": outs_m[1]}


def kernel_and_plain(ckpt: Path, bpath: Path, patch,
                     device: str = "cuda"):
    """The checkpoint's model on one patch with the kernel and with its
    plain version swapped in -> (z_type, z_phase) of each, float32 numpy."""
    import torch

    from forest_tpu_torch.data import parse_bindings
    from forest_tpu_torch.data.feature_builder import FeatureBuilder
    from forest_tpu_torch.eval.frozen import load_frozen_model
    from forest_tpu_torch.models import spatial
    from forest_tpu_torch.ops import smoothing as sm

    model = load_frozen_model(ckpt, device)
    fb = FeatureBuilder(parse_bindings(str(bpath)))
    groups = {k: torch.as_tensor(v[None]).to(device)
              for k, v in patch.items()}

    def run():
        with torch.inference_mode():
            x, _ = fb.build_feature("type_encoder_input", groups)
            zt = model(x)
            px, _ = fb.build_feature("phase_ccdc", groups)
            zp = model.forward_phase(px, zt)
        return zt[0].float().cpu().numpy(), zp[0].float().cpu().numpy()

    kernel = run()
    spatial.bank_mix = sm.bank_mix_reference
    try:
        plain = run()
    finally:
        spatial.bank_mix = sm.bank_mix
    return kernel, plain


def check_against_plain(ckpt: Path, bpath: Path, patch, served,
                        device: str = "cuda") -> dict:
    """Run the served model on one patch with the kernel and with its plain
    version swapped in; compare both to the HTTP response."""
    import numpy as np

    (kernel_zt, kernel_zp), (plain_zt, plain_zp) = kernel_and_plain(
        ckpt, bpath, patch, device)
    res = {}
    for name, k, p, s in (("z_type", kernel_zt, plain_zt, served["z_type"]),
                          ("z_phase", kernel_zp, plain_zp,
                           served["z_phase"])):
        rel = float(np.abs(k - p).max() / max(np.abs(p).max(), 1e-12))
        res[name] = {"rel_err_vs_plain": rel,
                     "max_abs_err_served_vs_direct":
                         float(np.abs(s - k).max())}
        if not rel <= SERVE_REL_BOUND:
            raise AssertionError(f"{name}: kernel vs plain model rel err "
                                 f"{rel} > {SERVE_REL_BOUND}")
    log(f"served vs plain model: {json.dumps(res)} "
        f"(bound {SERVE_REL_BOUND})")
    return res


def check_fixture() -> dict:
    """Phase 13: the committed blosc-LZ4 cube read on the card's machine,
    which has no libblosc, by the port's own decoders; its patches through
    ``ForestDatasetV2`` and one through ``FeatureBuilder`` on the card."""
    import hashlib

    import numpy as np
    import torch
    import yaml

    from forest_tpu_torch.data import blosc1, native
    from forest_tpu_torch.data import zarrlite as zl
    from forest_tpu_torch.data.bindings import parse_bindings
    from forest_tpu_torch.data.feature_builder import FeatureBuilder
    from forest_tpu_torch.data.frl_dataset import ForestDatasetV2

    root = ROOT / FIXTURE
    cube = root / "cube.zarr"
    sums = json.loads((root / "checksums.json").read_text())
    t0 = time.perf_counter()
    if not native.available():
        raise AssertionError("the native chunk decoder did not build")
    res = {"libblosc_loads": zl.blosc_available(), "arrays": len(sums)}
    # every chunk through both decoders, byte for byte
    chunks = [p for p in cube.rglob("*")
              if p.is_file() and not p.name.startswith(".")]
    for p in chunks:
        buf = p.read_bytes()
        if native.blosc_decompress(buf) != blosc1.decompress(buf):
            raise AssertionError(f"the decoders disagree on {p}")
    res["chunks_compared"] = len(chunks)
    # every array through the native path, then through the Python one
    native.decoded = 0
    for decoder in ("native", "python"):
        if decoder == "python":
            saved, native.available = native.available, lambda: False
        try:
            for rel, want in sums.items():
                a = np.asarray(zl.ZarrArray(cube / rel))
                if hashlib.sha256(a.tobytes()).hexdigest() != want["sha256"] \
                        or list(a.shape) != want["shape"]:
                    raise AssertionError(f"{decoder} decoder: {rel} does "
                                         f"not match checksums.json")
        finally:
            if decoder == "python":
                native.available = saved
        if decoder == "native":
            res["native_decoded_chunks"] = native.decoded
    if res["native_decoded_chunks"] != len(chunks):
        raise AssertionError(f"the native decoder decoded "
                             f"{res['native_decoded_chunks']} of "
                             f"{len(chunks)} chunks")
    # the dataset and the features, on the card
    raw = yaml.safe_load((root / "bindings.yaml").read_text())
    raw["zarr"]["path"] = str(root / raw["zarr"]["path"])
    raw["stats"]["file"] = str(root / raw["stats"]["file"])
    bindings = parse_bindings(raw)
    ds = ForestDatasetV2(bindings, split=None, patch_size=FIXTURE_PATCH,
                         seed=SEED)
    patches = [ds.get_patch(i) for i in range(len(ds))]
    for p in patches:
        if p["annual"].shape != (T_STEPS, FIXTURE_PATCH, FIXTURE_PATCH, 4) \
                or p["static"].shape != (FIXTURE_PATCH, FIXTURE_PATCH, 4):
            raise AssertionError(f"patch shapes {p['annual'].shape}, "
                                 f"{p['static'].shape}")
    fb = FeatureBuilder(bindings,
                        json.loads((root / "stats.json").read_text()))
    groups = {k: torch.as_tensor(np.asarray(v, np.float32)[None],
                                 device="cuda")
              for k, v in patches[-1].items() if k != "__window__"}
    feats = {}
    for name in ("type_encoder_input", "phase_ccdc"):
        x, m = fb.build_feature(name, groups)
        if x.device.type != "cuda" or not bool(
                torch.isfinite(x[m]).all()) or not bool(m.any()):
            raise AssertionError(f"feature {name}: not finite on the card")
        feats[name] = list(x.shape)
    res.update(patches=len(patches), features=feats)
    # a new array with the default compressor: zlib without libblosc
    with tempfile.TemporaryDirectory() as d:
        a = zl.create_array(Path(d) / "a", (40, 40), (32, 32), np.float32)
        a[:] = np.arange(1600, dtype=np.float32).reshape(40, 40)
        res["default_compressor"] = a.compressor["id"]
        back = np.asarray(zl.ZarrArray(Path(d) / "a"))
        if (not res["libblosc_loads"] and a.compressor["id"] != "zlib") or \
                not np.array_equal(back, np.arange(1600).reshape(40, 40)):
            raise AssertionError(f"default compressor {a.compressor}")
    res["seconds"] = time.perf_counter() - t0
    log(f"fixture: {json.dumps(res)}")
    return res


def _wrappers() -> dict:
    """Kernel name -> the wrapper that counts its launches."""
    from forest_tpu_torch.ops import scatter as sc
    from forest_tpu_torch.ops import smoothing as sm
    from forest_tpu_torch.ops import vq
    from forest_tpu_torch.ops import vq_variants as vv
    return {"bank_mix_fwd": sm.bank_mix, "bank_mix_bwd": sm.bank_mix_bwd,
            "scatter_add_rows": sc.scatter_add_rows, "vq_core": vq.vq_core,
            "vq_assign": vq.vq_assign, "vq_variant_rows": vv.make_assign,
            "vq_variant_cols": vv.make_assign_t}


def reset_launches() -> None:
    for wrapper in _wrappers().values():
        wrapper.launches = 0


def read_launches() -> dict:
    return {name: w.launches for name, w in _wrappers().items()}


EVT_CODES = (7001, 7002, 7003)      # synthetic_frl_batch's EVT codes
EVT_WEIGHT = 0.1
# the production sampling strategy: 300 anchors per 256 x 256 patch
PRODUCTION_SAMPLING = {
    "grid": {"stride": 16, "exclude_border": 16, "jitter": {"radius": 4}},
    "supplement": {"n": 104, "sampling": {
        "type": "weighted",
        "weight_by": ["static_mask.aoi", "static_mask.forest"]}},
}


def build_train_step(device: str = "cuda", evt_dir: Optional[Path] = None,
                     diag: bool = False, bsz: Optional[int] = None):
    """The v1 model with seeded weights, the synthetic bindings with the
    production sampling strategy (stride 16, border 16, jitter 4, 104
    weighted supplement anchors: 300 per 256 x 256 patch), the port's
    process_batch (every loss of DEFAULT_WEIGHTS, the weights of
    configs/frl_training_v1.yaml at full ramp) and train_step over them,
    and one synthetic batch of ``bsz`` (TRAIN_SHAPE's 12 unless given) on
    the device. With ``evt_dir`` the EVT loss is on too (weight EVT_WEIGHT;
    its confusion CSV is written there), and ``diag`` adds the
    diagnostics. -> a namespace: model, process, sampler,
    step_cfg, batch, weights, curriculum, gen, optimizer, state,
    train_step."""
    from types import SimpleNamespace

    import numpy as np
    import torch
    import yaml

    from forest_tpu_torch.data import (parse_bindings, synthetic_bindings,
                                       synthetic_feature_stats,
                                       synthetic_frl_batch)
    from forest_tpu_torch.data.feature_builder import FeatureBuilder
    from forest_tpu_torch.losses.evt_soft_neighborhood import (
        EvtDiffusionMetric, write_synthetic_confusion_csv)
    from forest_tpu_torch.models import representation as rep
    from forest_tpu_torch.training.representation import (
        config_builders as cb, step as step_mod, train_step as ts)

    cfg = yaml.safe_load((ROOT / "configs/frl_repr_model_v1.yaml")
                         .read_text())
    raw = synthetic_bindings("unused.zarr", "unused.json")
    training_cfg, evt_tables = {}, None
    weights = dict(step_mod.DEFAULT_WEIGHTS)
    if evt_dir is not None:
        csv_path = write_synthetic_confusion_csv(
            evt_dir / "evt_confusion.csv", EVT_CODES, seed=SEED)
        raw["losses"]["evt_soft_neighborhood"] = {
            "feature": "static_categorical.evt",
            "confusion_csv": str(csv_path)}
        training_cfg = {"loss_weights": {"evt": EVT_WEIGHT}}
        weights["evt"] = EVT_WEIGHT
        evt_tables = step_mod.build_evt_tables(EvtDiffusionMetric(
            csv_path, {c: 1000 for c in EVT_CODES}, min_count=10))
    bindings = parse_bindings(raw)
    bindings.sampling_strategies["grid-plus-supplement"] = \
        PRODUCTION_SAMPLING
    fb = FeatureBuilder(bindings, synthetic_feature_stats(bindings))
    type_in = len(bindings.get_feature("type_encoder_input").channels)
    phase_in = len(bindings.get_feature("phase_ccdc").channels)
    model = rep.from_config(cfg, type_in, phase_in)
    rep.init_parameters(model, torch.Generator().manual_seed(SEED))
    step_cfg = cb.build_step_config(bindings, training_cfg)
    if step_cfg.evt_enabled != (evt_dir is not None):
        raise AssertionError(f"evt_enabled {step_cfg.evt_enabled}")
    sampler = cb.build_sampler(bindings, training_cfg)
    bsz, hw = bsz or TRAIN_SHAPE[0], TRAIN_SHAPE[1]
    process = step_mod.make_process_batch(
        model, fb, sampler, step_cfg, hw, evt_tables=evt_tables, diag=diag,
        device=device)
    batch = {k: torch.as_tensor(v).to(device) for k, v in
             synthetic_frl_batch(np.random.default_rng(SEED), bsz, hw,
                                 T_STEPS).items()}
    optimizer = ts.make_optimizer(1e-4)
    return SimpleNamespace(
        model=model, process=process, sampler=sampler, step_cfg=step_cfg,
        batch=batch, weights=weights,
        curriculum={"input_dropout_rate": 0.05, "min_gate": 0.0},
        gen=torch.Generator(device=device).manual_seed(SEED),
        optimizer=optimizer, state=ts.init_train_state(model, optimizer),
        train_step=ts.make_train_step(process, optimizer))


def loss_and_grad_norm(model, process, batch, weights, curriculum, draws):
    import torch

    from forest_tpu_torch.training.representation import train_step as ts
    loss, metrics = process(batch, None, weights, curriculum, True, draws)
    grads = torch.autograd.grad(loss, list(model.parameters()),
                                allow_unused=True)
    gnorm = ts.global_norm([g for g in grads if g is not None])
    torch.cuda.synchronize()
    return metrics["loss_total"].item(), gnorm.item(), metrics


def kernel_vs_plain(t, device: str = "cuda") -> dict:
    """One step of ``t`` (build_train_step's namespace) with the kernels and
    the same step, same weights and draws, with their plain versions
    swapped in: loss_total and the global gradient norm within
    STEP_LOSS_REL_BOUND / STEP_GNORM_REL_BOUND. -> the two steps, their
    differences and the kernels' step's metrics."""
    from forest_tpu_torch.models import spatial
    from forest_tpu_torch.ops import scatter as sc
    from forest_tpu_torch.ops import smoothing as sm
    from forest_tpu_torch.training.representation import step as step_mod

    bsz, hw = TRAIN_SHAPE[0], TRAIN_SHAPE[1]
    draws = step_mod.draw_step_randoms(t.gen, bsz, hw, t.sampler,
                                       t.step_cfg, t.model, True, device)
    args = (t.model, t.process, t.batch, t.weights, t.curriculum, draws)
    kernels = (sm.bank_mix, sm.bank_mix_bwd, sc.scatter_add_rows)
    before = [k.launches for k in kernels]
    k_loss, k_gnorm, metrics = loss_and_grad_norm(*args)
    if any(k.launches == n for k, n in zip(kernels, before)):
        raise AssertionError("the kernel step did not launch K1, K2, K3")
    spatial.bank_mix = sm.bank_mix_reference
    kernel_scatter = sc.scatter_add_rows
    sc.scatter_add_rows = lambda dz, idx, n_rows, check_index=True: \
        sc.scatter_add_rows_reference(dz, idx, n_rows)
    try:
        before = [k.launches for k in kernels]
        p_loss, p_gnorm, _ = loss_and_grad_norm(*args)
        if [k.launches for k in kernels] != before:
            raise AssertionError("the plain step launched a kernel")
    finally:
        spatial.bank_mix = sm.bank_mix
        sc.scatter_add_rows = kernel_scatter
    res = {"kernel_step": {"loss_total": k_loss, "grad_norm": k_gnorm},
           "plain_step": {"loss_total": p_loss, "grad_norm": p_gnorm},
           "loss_rel_diff": abs(k_loss - p_loss) / abs(p_loss),
           "grad_norm_rel_diff": abs(k_gnorm - p_gnorm) / abs(p_gnorm)}
    log(f"training step, kernels vs plain versions: {json.dumps(res)} "
        f"(bounds {STEP_LOSS_REL_BOUND}, {STEP_GNORM_REL_BOUND})")
    if not (res["loss_rel_diff"] <= STEP_LOSS_REL_BOUND
            and res["grad_norm_rel_diff"] <= STEP_GNORM_REL_BOUND):
        raise AssertionError(f"kernel step disagrees with plain step: {res}")
    return dict(res, metrics={k: float(v) for k, v in metrics.items()})


# the weighted losses of the step and their metric keys
WEIGHTED_LOSSES = {
    "spatial_infonce": "loss_spatial_infonce",
    "spectral_infonce": "loss_spectral_infonce",
    "vicreg_type": "loss_vicreg_type", "vicreg_phase": "loss_vicreg_phase",
    "phase_neighborhood": "loss_phase_neighborhood",
    "phase_spread": "loss_phase_spread",
    "recovery_disc": "loss_recovery_disc",
    "type_leakage": "loss_type_leakage", "evt": "loss_evt"}
PHASE_PARAMS = ("phase_tcn.", "phase_head.", "phase_film.")


def check_step_metrics(metrics: dict, weights: dict, label: str) -> None:
    """Every weighted loss finite, phase pairs found, every metric finite."""
    import numpy as np
    on = {w: WEIGHTED_LOSSES[w] for w, v in weights.items() if v}
    bad = [k for k, v in metrics.items() if not np.isfinite(v)]
    if bad or metrics["phase_pairs_valid"] <= 0 \
            or metrics.get("skipped", 0) != 0:
        raise AssertionError(f"{label}: non-finite {bad}, phase pairs "
                             f"{metrics['phase_pairs_valid']}, skipped "
                             f"{metrics.get('skipped')}")
    missing = [k for k in on.values() if k not in metrics]
    if missing:
        raise AssertionError(f"{label}: no metric for {missing}")


def train_and_check(device: str = "cuda") -> dict:
    import torch

    from forest_tpu_torch.training.representation import train_step as ts

    bsz, hw = TRAIN_SHAPE[0], TRAIN_SHAPE[1]
    t = build_train_step(device)
    model, process, sampler = t.model, t.process, t.sampler
    batch, weights, curriculum, gen = (t.batch, t.weights, t.curriculum,
                                       t.gen)
    optimizer, state, train_step = t.optimizer, t.state, t.train_step
    a = sampler.n_anchors(hw, hw)
    on = [k for k, v in weights.items() if v]
    log(f"training: B={bsz} {hw}x{hw} T={T_STEPS}, {a} anchors per patch, "
        f"{sum(p.numel() for p in model.parameters())} params, weights "
        f"{ {k: weights[k] for k in on} }")
    if len(on) != 8:
        raise AssertionError(f"expected the eight non-EVT losses on: {on}")
    res = kernel_vs_plain(t, device)
    check_step_metrics(res.pop("metrics"), weights, "kernel step")

    # the main path: train_step on the card
    start = {k: v.clone() for k, v in model.state_dict().items()}
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    step_ms, history = [], []
    n_steps = TRAIN_STEPS_WARM + TRAIN_STEPS_TIMED
    for i in range(n_steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = train_step(state, batch, gen, weights, curriculum)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        metrics = {k: float(v) for k, v in metrics.items()}
        history.append(metrics)
        log(f"train step {i}: {step_ms[-1]:.1f} ms  "
            + "  ".join(f"{k}={metrics[k]:.4g}" for k in (
                ["loss_total"] + [WEIGHTED_LOSSES[w] for w in on]
                + ["phase_pairs_valid", "grad_norm", "n_anchors_valid",
                   "skipped"])))
        check_step_metrics(metrics, weights, f"train step {i}")
    launches = {k: v for k, v in read_launches().items()
                if k in ("bank_mix_fwd", "bank_mix_bwd", "scatter_add_rows")}
    if any(n < n_steps for n in launches.values()):
        raise AssertionError(f"{n_steps} train steps launched {launches}")
    if state.step != n_steps or state.count != n_steps:
        raise AssertionError(f"state after {n_steps} steps: step "
                             f"{state.step}, updates {state.count}")
    moved = sum(not torch.equal(v, start[k])
                for k, v in model.state_dict().items())
    type_params = sum(k.startswith(("encoder.", "spatial_conv."))
                      for k in start)
    still = [k for k, v in model.state_dict().items()
             if k.startswith(PHASE_PARAMS) and torch.equal(v, start[k])]
    if moved < type_params or still:
        raise AssertionError(f"only {moved} parameter tensors changed; "
                             f"phase tensors unchanged: {still}")

    # where one step's time goes: forward, backward, optimizer
    names, params = zip(*model.named_parameters())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, _ = process(batch, gen, weights, curriculum, True)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    grads = {n: (torch.zeros_like(p) if g is None else g)
             for n, p, g in zip(names, params, grads)}
    ts.apply_update(state, optimizer, grads, ts.global_norm(grads.values()))
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    stages = {"forward_ms": (t1 - t0) * 1e3, "backward_ms": (t2 - t1) * 1e3,
              "optimizer_ms": (t3 - t2) * 1e3}
    timed = sorted(step_ms[TRAIN_STEPS_WARM:])
    res.update({
        "steps": n_steps, "launches": launches,
        "first_step_ms": step_ms[0],
        "step_ms_median": timed[len(timed) // 2],
        "step_ms_min": timed[0], "step_ms_max": timed[-1],
        "stages_of_one_step": stages,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "loss_total_first": history[0]["loss_total"],
        "loss_total_last": history[-1]["loss_total"],
        "losses_last": {w: history[-1][WEIGHTED_LOSSES[w]] for w in on},
        "tensors_changed": moved,
        "phase_tensors": sum(k.startswith(PHASE_PARAMS) for k in start)})
    log(f"full FRL train step: {res['step_ms_median']:.2f} ms median "
        f"(min {res['step_ms_min']:.2f}, max {res['step_ms_max']:.2f}) of "
        f"{TRAIN_STEPS_TIMED}; one step forward "
        f"{stages['forward_ms']:.2f} / backward {stages['backward_ms']:.2f} "
        f"/ optimizer {stages['optimizer_ms']:.2f} ms; peak "
        f"{res['peak_memory_gb']:.2f} GB; {moved} tensors moved")
    return res


def evt_diag_step_check(device: str = "cuda") -> dict:
    """Phase 8b: one step with EVT on (weight EVT_WEIGHT, tables from a
    confusion CSV over the batch's codes) and the diagnostics, against the
    same step with the plain kernels; loss_evt finite and non-zero, every
    diagnostic finite."""
    import numpy as np
    import torch
    with tempfile.TemporaryDirectory() as d:
        t = build_train_step(device, evt_dir=Path(d), diag=True)
        res = kernel_vs_plain(t, device)
    metrics = res.pop("metrics")
    check_step_metrics(metrics, t.weights, "EVT + diag step")
    diag = {k: v for k, v in metrics.items()
            if k.startswith(("diag_", "leak_"))}
    bad = [k for k, v in diag.items() if not np.isfinite(v)]
    if not (np.isfinite(metrics["loss_evt"]) and metrics["loss_evt"] > 0) \
            or bad or len(diag) != 106:
        raise AssertionError(f"EVT + diag step: loss_evt "
                             f"{metrics['loss_evt']}, {len(diag)} "
                             f"diagnostics, non-finite {bad}")
    res.update(loss_evt=metrics["loss_evt"],
               evt_anchors_valid=metrics["evt_anchors_valid"],
               diagnostics=len(diag),
               leak_r2_mean=metrics["leak_r2_mean"])
    log(f"EVT + diag step: {json.dumps(res)}")
    del t
    torch.cuda.empty_cache()
    return res


# phase 14: the FRL training CLI on a synthetic v2 cube of 1536 x 1536
# (chunks of 256), which configs/frl_training_v1.yaml's split (blocks of
# 4 x 4 patches of 256, min_aoi 0.3) cuts into 16 train and 4 val patches
CLI_CUBE_HW, CLI_CHUNK = 1536, 256
CLI_EPOCHS = 2


def cli_configs(tmp: Path):
    """The bindings (synthetic_bindings over the cube in ``tmp``, with the
    production sampling strategy) and configs/frl_training_v1.yaml with its
    run root in ``tmp``, written there. -> (training path, bindings
    path)."""
    import yaml

    from forest_tpu_torch.data import synthetic_bindings
    raw = synthetic_bindings(tmp / "cube.zarr", tmp / "stats.json")
    raw["sampling-strategy"]["grid-plus-supplement"] = PRODUCTION_SAMPLING
    bpath = tmp / "bindings.yaml"
    bpath.write_text(yaml.safe_dump(raw))
    training = yaml.safe_load((ROOT / "configs/frl_training_v1.yaml")
                              .read_text())
    training["run"]["run_root"] = str(tmp / "runs")
    tpath = tmp / "training.yaml"
    tpath.write_text(yaml.safe_dump(training))
    return tpath, bpath


def count_syncs(trace: Path) -> dict:
    """Host synchronisations in a Chrome trace of torch.profiler, by
    call."""
    events = json.loads(trace.read_text())["traceEvents"]
    out = {}
    for ev in events:
        if ev.get("name") in SYNC_CALLS:
            out[ev["name"]] = out.get(ev["name"], 0) + 1
    return out


def cli_train_and_check(tmp: Path, device: str = "cuda") -> dict:
    """Phase 14: ``train_representation.main`` as a user runs it, on a
    synthetic cube it computes the stats of, for CLI_EPOCHS epochs with the
    phase losses on from epoch 1, then resumed for one epoch more under
    ``--profile``; the resumed checkpoint served through EncoderService and
    held to the plain model. The cube, the bindings and the run stay in
    ``tmp`` for phase 15. -> per-epoch readings, the launches of K1-K3 on
    the path, host syncs per step."""
    import numpy as np
    import torch

    from forest_tpu_torch.data.cube_v2 import build_synthetic_v2_cube
    from forest_tpu_torch.serving import EncoderService
    from forest_tpu_torch.training import train_representation as tr
    from forest_tpu_torch.training.checkpointing import load_state_raw

    t0 = time.perf_counter()
    build_synthetic_v2_cube(tmp / "cube.zarr", height=CLI_CUBE_HW,
                            width=CLI_CUBE_HW, chunk_yx=CLI_CHUNK)
    cube_s = time.perf_counter() - t0
    tpath, bpath = cli_configs(tmp)
    argv = ["--training", str(tpath), "--bindings", str(bpath),
            "--model-config",
            str(ROOT / "configs/frl_repr_model_v1.yaml"),
            "--phase-start-epoch", "0"]
    if device != "cuda":
        argv += ["--device", device]
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    reset_launches()                                  # the main path
    first = tr.main(argv + ["--num-epochs", str(CLI_EPOCHS)])
    exp = tmp / "runs" / "frl_v1"     # frl_training_v1.yaml's run
    last = exp / "checkpoints" / "encoder_last.msgpack"
    saved_step = int(np.asarray(load_state_raw(last)[0]["step"]))
    resumed = tr.main(argv + ["--num-epochs", str(CLI_EPOCHS + 1),
                              "--profile"])
    launches = {k: v for k, v in read_launches().items()
                if k in ("bank_mix_fwd", "bank_mix_bwd",
                         "scatter_add_rows")}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if on_card \
        else None
    history = first["history"] + resumed["history"]
    n_train = sum(h["train/n_steps"] for h in history)
    n_val = sum(h["val/n_steps"] for h in history)
    syncs = count_syncs(exp / "logs" / "trace" / "trace.json")

    problems = []
    if resumed["start_epoch"] != CLI_EPOCHS:
        problems.append(f"resumed at epoch {resumed['start_epoch']}")
    if resumed["state"].step != saved_step + \
            resumed["history"][0]["train/n_steps"]:
        problems.append(f"resumed step {resumed['state'].step} from "
                        f"saved {saved_step}")
    if [h["epoch"] for h in history] != list(range(CLI_EPOCHS + 1)):
        problems.append(f"epochs {[h['epoch'] for h in history]}")
    for h in history:
        bad = [k for k, v in h.items() if "/loss_" in k
               and not np.isfinite(v)]
        if bad or h["train/skipped"] != 0:
            problems.append(f"epoch {h['epoch']}: non-finite {bad}, "
                            f"skipped {h['train/skipped']}")
    if history[1]["train/phase_pairs_valid"] <= 0:
        problems.append("no phase pairs in epoch 1")
    if launches["bank_mix_fwd"] < n_train + n_val or \
            launches["bank_mix_bwd"] < n_train or \
            launches["scatter_add_rows"] < n_train:
        problems.append(f"{n_train} train and {n_val} val steps "
                        f"launched {launches}")
    for f in ("history.json", "provenance.json", "configs/model.yaml",
              "checkpoints/encoder_last.msgpack.json",
              "checkpoints/encoder_epoch_000.msgpack"):
        if not (exp / f).exists():
            problems.append(f"no {f}")
    if problems:
        raise AssertionError(f"training CLI: {problems}")

    # the trained encoder, served
    patch = resumed["ds_val"].get_patch(0)
    svc = EncoderService(last, bpath, device=device, max_batch=8)
    try:
        served = svc.encode(patch, phase=True)
    finally:
        svc.close()
    plain = check_against_plain(last, bpath, patch, served, device)
    stats_s = first["stats_s"]
    wait = cli_wait_probe(resumed, device)
    epochs = [{
        "epoch": h["epoch"], "n_steps": h["train/n_steps"],
        "ms_per_step": 1e3 * h["train/step_s"] / h["train/n_steps"],
        "wait_share": h["train/wait_s"] / h["train/epoch_time_s"],
        "epoch_time_s": h["train/epoch_time_s"],
        "val_epoch_time_s": h["val/epoch_time_s"],
        "train_loss_total": h["train/loss_total"],
        "val_loss_total": h["val/loss_total"],
        "profiled": h["epoch"] == CLI_EPOCHS} for h in history]
    traced_steps = resumed["history"][0]["train/n_steps"]
    return {"cube_s": cube_s, "stats_s": stats_s, "epochs": epochs,
            "launches": launches, "train_steps": n_train,
            "val_steps": n_val, "saved_step": saved_step,
            "resumed_step": resumed["state"].step,
            "syncs_per_step": {k: v / traced_steps
                               for k, v in syncs.items()},
            "peak_memory_gb": peak_gb,
            "served_rel_err_vs_plain": plain["z_type"]["rel_err_vs_plain"],
            "one_batch": wait}


def cli_wait_probe(ctx: dict, device: str, steps: int = 3) -> dict:
    """Where a CLI step's wait and time go, after the path's launches were
    read: one batch of the train set decoded on the host (``load_batch``),
    its pinned copy to the device (``make_device_put``, synchronised), and
    ``steps`` of the CLI's own train step on that resident batch (the
    diagnostics on, as the CLI runs it), host clock around a synchronise."""
    import numpy as np
    import torch

    from forest_tpu_torch.data.loader import make_device_put

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    ds, bsz = ctx["ds_train"], TRAIN_SHAPE[0]
    t0 = time.perf_counter()
    batch = ds.load_batch([i % len(ds) for i in range(bsz)])
    load_s = time.perf_counter() - t0
    batch["__sample_valid__"] = np.ones(bsz, bool)
    sync()
    t0 = time.perf_counter()
    db = make_device_put(device, keep_host_keys=())(batch)
    sync()
    put_s = time.perf_counter() - t0
    full = {k: torch.full((), float(v), device=device)
            for k, v in ctx["weights"].items()}
    cur = {"input_dropout_rate": torch.full((), 0.0, device=device),
           "min_gate": torch.full((), 1.0, device=device)}
    state, times = ctx["state"], []
    for i in range(steps + 1):
        sync()
        t0 = time.perf_counter()
        state, _ = ctx["train_step"](
            state, db, torch.Generator(device=device).manual_seed(i), full,
            cur)
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return {"load_batch_s": load_s, "device_put_s": put_s,
            "batch_mb": sum(v.nbytes for v in batch.values()) / 1e6,
            "resident_step_ms": sorted(times[1:])[steps // 2]}


# phase 15: the eval tools on phase 14's cube and last checkpoint
EVAL_POINTS, EVAL_POINTS_OUTSIDE = 50, 5
EVAL_PROBE_EPOCHS = 2
EVAL_PCA_K = 20                 # phase_probe's default interaction PCA k
F16_REL = 2.0 ** -10            # one float16 rounding, relative


def _timed(fn, *args, **kw):
    """-> (fn's result, seconds, K1's launches), the count set to 0 just
    before and read just after."""
    import torch
    reset_launches()
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0, read_launches()["bank_mix_fwd"]


def export_batch_probe(tmp: Path, ckpt: Path, bpath: Path, ds,
                       device: str) -> dict:
    """Where a batch of the export's time goes, after its launches were
    read: 4 patches decoded on the host (``load_batch``), their copy to the
    device, the type and dense phase paths on the device (warm, host clock
    around a synchronise), the float16 copy back, and the zarr write of the
    batch (``export_embeddings._drain`` into arrays of a scratch group, one
    thread, as the export's writer runs it)."""
    import torch

    from forest_tpu_torch.data import zarrlite as zl
    from forest_tpu_torch.data.feature_builder import FeatureBuilder
    from forest_tpu_torch.eval import export_embeddings as ee
    from forest_tpu_torch.eval import frozen

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    idx = list(range(4))
    fb = FeatureBuilder(ds.bindings)
    keep = ds.bindings.groups_for_features(["type_encoder_input",
                                            "phase_ccdc"])
    model = frozen.load_frozen_model(ckpt, device)
    enc_t, _, _ = frozen.make_encode_fns(model, fb)
    enc_p = ee.make_encode_phase_dense(model, fb)
    t0 = time.perf_counter()
    host = ds.load_batch(idx)
    load_s = time.perf_counter() - t0
    sync()
    t0 = time.perf_counter()
    batch = frozen.batch_to_device(host, device, keep)
    sync()
    put_s = time.perf_counter() - t0
    times = []
    for _ in range(3):                       # the first run warms up
        sync()
        t0 = time.perf_counter()
        with torch.inference_mode():
            zt = enc_t(batch)
            zp, z = enc_p(batch, zt).half(), zt.half()
        sync()
        times.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    z_h, zp_h = z.cpu(), zp.cpu()
    d2h_s = time.perf_counter() - t0
    root = zl.create_group(tmp / "probe_batch.zarr")
    p = ds.patch_size
    zt_arr = root.create_array("z_type", (ds.height, ds.width, z.shape[-1]),
                               (p, p, z.shape[-1]), "float16",
                               fill_value=float("nan"))
    zp_arr = root.create_array(
        "z_phase", (zp.shape[1], ds.height, ds.width, zp.shape[-1]),
        (1, p, p, zp.shape[-1]), "float16", fill_value=float("nan"))
    t0 = time.perf_counter()
    ee._drain((idx, z_h, zp_h), ds, zt_arr, zp_arr)
    write_s = time.perf_counter() - t0
    mb = (z_h.numel() + zp_h.numel()) * 2 / 1e6
    return {"load_batch_s": load_s, "device_put_s": put_s,
            "device_ms": 1e3 * sorted(times[1:])[0],
            "d2h_s": d2h_s, "write_s": write_s, "float16_mb": mb,
            "write_mb_per_s": mb / write_s,
            "compressor": zt_arr.compressor["id"]}


def eval_tools_and_check(tmp: Path, device: str = "cuda") -> dict:
    """Phase 15: the four eval CLIs as a user runs them on the card, on
    phase 14's 1536 x 1536 cube and the last checkpoint it trained (v1:
    z_type 48, z_phase 8, bf16 smoothing). (a) ``export_embeddings`` with
    ``--phase`` over all 36 patches of 256: float16 ``z_type`` and
    ``z_phase`` finite inside the AOI, one patch within SERVE_REL_BOUND of
    the model run with K1's plain version, K1 launched on every batch; (b)
    ``embed_locations`` on EVAL_POINTS points (EVAL_POINTS_OUTSIDE of them
    off the cube) at patches of 256: every column family, ``valid: 0``
    off the cube, ``z_type_*`` equal to (a)'s export at those pixels within
    a float16 rounding (the export stores float16); (c) ``train_probe`` for
    EVAL_PROBE_EPOCHS epochs on ``infonce_type_spectral`` (patches of 128,
    B 4): history rows, a finite val R^2, both npz files; (d)
    ``phase_probe`` with ``--design full``: finite train and val metrics,
    W of [8 + 48 + EVAL_PCA_K + 1, C]. -> seconds, K1's launches per tool
    and the export's rate and bytes. The widths are read from the
    checkpoint; another ``device`` runs the same checks but K1's counts."""
    import csv

    import numpy as np

    from forest_tpu_torch.data import parse_bindings
    from forest_tpu_torch.data import zarrlite as zl
    from forest_tpu_torch.data.frl_dataset import ForestDatasetV2
    from forest_tpu_torch.eval import (embed_locations, export_embeddings,
                                       phase_probe, train_probe)
    from forest_tpu_torch.training.checkpointing import load_state_raw

    ckpt = tmp / "runs" / "frl_v1" / "checkpoints" / "encoder_last.msgpack"
    bpath = tmp / "bindings.yaml"
    model = load_state_raw(ckpt)[1]["model_config"]["model"]
    zt_dim, zp_dim = model["z_type_dim"], model["z_phase_dim"]
    common = ["--checkpoint", str(ckpt), "--bindings", str(bpath)]
    if device != "cuda":
        common += ["--device", device]
    on_card = device == "cuda"
    res, problems = {}, []

    # (a) the dense export
    out = tmp / "embeddings.zarr"
    _, sec, k1 = _timed(export_embeddings.main,
                        common + ["--out", str(out), "--phase"])
    ds = ForestDatasetV2(parse_bindings(str(bpath)), split=None,
                         patch_size=256)
    n_patches = len(ds.patches)
    n_batches = -(-n_patches // 4)
    nbytes = sum(f.stat().st_size for f in out.rglob("*") if f.is_file())
    emb = zl.open_zarr(out)
    zt, zp = emb["z_type"], emb["z_phase"]
    shapes = {"z_type": list(zt.shape), "z_phase": list(zp.shape)}
    if shapes != {"z_type": [CLI_CUBE_HW, CLI_CUBE_HW, zt_dim],
                  "z_phase": [T_STEPS, CLI_CUBE_HW, CLI_CUBE_HW, zp_dim]} or \
            zt.dtype != np.float16 or zp.dtype != np.float16:
        problems.append(f"export: {shapes}, {zt.dtype}, {zp.dtype}")
    zt_all = np.asarray(zt)
    aoi = np.asarray(zl.open_zarr(tmp / "cube.zarr")["aoi"]) > 0
    zp_finite = all(bool(np.isfinite(np.asarray(zp[t_])[aoi]).all())
                    for t_ in range(T_STEPS))
    if not (np.isfinite(zt_all[aoi]).all() and zp_finite):
        problems.append("export: non-finite embeddings inside the AOI")
    if on_card and k1 < n_batches:
        problems.append(f"export: {n_batches} batches launched K1 {k1}")
    j = n_patches // 2
    win = ds.patches[j]
    _, (plain_zt, plain_zp) = kernel_and_plain(ckpt, bpath, ds.get_patch(j),
                                               device)
    rel = {}
    for name, got, ref in (
            ("z_type", zt_all[win.row_slice, win.col_slice], plain_zt),
            ("z_phase", np.asarray(zp[:, win.row_slice, win.col_slice]),
             plain_zp)):
        rel[name] = float(np.abs(got.astype(np.float32) - ref).max()
                          / max(np.abs(ref).max(), 1e-12))
        if not rel[name] <= SERVE_REL_BOUND:
            problems.append(f"export {name}: {rel[name]} from the plain "
                            f"model > {SERVE_REL_BOUND}")
    res["export"] = {"seconds": sec, "k1_launches": k1, "batches": n_batches,
                     "patches": n_patches,
                     "patches_per_s": n_patches / sec,
                     "mb_written": nbytes / 1e6,
                     "rel_err_vs_plain": rel,
                     "one_batch": export_batch_probe(tmp, ckpt, bpath, ds,
                                                     device)}

    # (b) points, some off the cube
    rng = np.random.default_rng(SEED)
    n_in = EVAL_POINTS - EVAL_POINTS_OUTSIDE
    pts = [(int(r), int(c)) for r, c in
           rng.integers(0, CLI_CUBE_HW, (n_in, 2))]
    pts += [(CLI_CUBE_HW + 10 * i, i) for i in range(EVAL_POINTS_OUTSIDE)]
    years = [int(y) for y in rng.integers(2008, 2027, EVAL_POINTS)]
    locs = tmp / "points.csv"
    with open(locs, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["row", "col", "year"])
        w.writerows([r, c, y] for (r, c), y in zip(pts, years))
    rows, sec, k1 = _timed(
        embed_locations.main,
        common + ["--locations", str(locs), "--output",
                  str(tmp / "points_emb.csv"), "--patch-size", "256",
                  "--evt-source", "static_categorical.evt"])
    ok = [r for r in rows if r.get("valid")]
    families = ("pixel_row", "pixel_col", "split", "ysfc", "evt",
                "x_type_0", "x_phase_0", f"z_type_{zt_dim - 1}",
                f"z_phase_{zp_dim - 1}", f"g_type_{zt_dim - 1}")
    missing = [k for k in families if k not in ok[0]] if ok else families
    if len(ok) != n_in or missing or any(r.get("valid") != 0
                                         for r in rows[n_in:]):
        problems.append(f"embed: {len(ok)} of {n_in} points, missing "
                        f"{missing}")
    err = 0.0
    for r in ok:
        z = np.asarray([r[f"z_type_{d}"] for d in range(zt_dim)])
        ref = zt_all[r["pixel_row"], r["pixel_col"]].astype(np.float64)
        err = max(err, float((np.abs(z - ref)
                              / (F16_REL * np.abs(ref) + 1e-5)).max()))
    if not err <= 1.0:
        problems.append(f"embed: z_type off the export by {err} float16 "
                        "roundings")
    touched = len({(r["pixel_row"] // 256, r["pixel_col"] // 256)
                   for r in ok})
    if on_card and k1 < touched:
        problems.append(f"embed: {touched} patches launched K1 {k1}")
    res["embed"] = {"seconds": sec, "k1_launches": k1, "points": len(rows),
                    "valid": len(ok), "patches": touched,
                    "z_type_vs_export_in_f16_roundings": err}

    # (c) the SGD probe
    pdir = tmp / "probe"
    probe, sec, k1 = _timed(
        train_probe.main,
        common + ["--target-feature", "infonce_type_spectral", "--epochs",
                  str(EVAL_PROBE_EPOCHS), "--output-dir", str(pdir)])
    hist = probe["history"]
    if len(hist) != EVAL_PROBE_EPOCHS or not all(
            np.isfinite(h["val_r2"]) for h in hist) or not all(
            (pdir / f).is_file() for f in ("probe_best.npz",
                                           "probe_final.npz",
                                           "probe_history.json")):
        problems.append(f"train_probe: {hist}")
    if on_card and k1 <= 0:
        problems.append("train_probe never launched K1")
    res["train_probe"] = {"seconds": sec, "k1_launches": k1,
                          "val_r2": [h["val_r2"] for h in hist],
                          "train_mse": [h["train_mse"] for h in hist]}

    # (d) the phase probe, full design
    pp, sec, k1 = _timed(
        phase_probe.main,
        common + ["--design", "full", "--output",
                  str(tmp / "phase_probe.json")])
    w_shape = list(pp["weights"].shape)
    n_ch = w_shape[1] if len(w_shape) == 2 else -1
    r2 = {s_: pp["metrics"][s_]["r2_total"] for s_ in ("train", "val")}
    if w_shape != [zp_dim + zt_dim + EVAL_PCA_K + 1, n_ch] or not all(
            np.isfinite(pp["metrics"][s_][k])
            for s_ in ("train", "val")
            for k in ("r2_total", "mse_total", "r2_total_original")):
        problems.append(f"phase_probe: W {w_shape}, R^2 {r2}")
    if on_card and k1 <= 0:
        problems.append("phase_probe never launched K1")
    res["phase_probe"] = {"seconds": sec, "k1_launches": k1,
                          "weights": w_shape,
                          "target": pp["target_feature"], "r2_total": r2,
                          "n_observations": {
                              s_: pp["metrics"][s_]["n_observations"]
                              for s_ in ("train", "val")}}
    if problems:
        raise AssertionError(f"eval tools: {problems}")
    return res


# phase 16: the clustering and FIA tools on phase 14's cube and checkpoint
FIA_POINTS = 2000
GMM_TIMED_K = 25                # the landscape sweep's middle K
# every type cluster of at least --min-cluster-pixels is dynamic, so the
# phase sweeps and the second pass run: the trained v1 model's 90th
# percentile of temporal variance stays below the default 0.25 on the
# synthetic cube (no dynamic cluster, one pass, on an H100)
DYNAMIC_VAR_THRESHOLD = "0"
CARD_VS_CPU_ROWS = 20_000
CARD_VS_CPU_REL = 1e-6          # float64 fits from the same host draws


def fia_table(tmp: Path, rows, zt_dim: int, hw: int) -> Path:
    """The points' embeddings with a seeded synthetic target pair (BALIVE,
    a linear score of z_type plus noise; REMV, zero-inflated removals on the
    same score), a survey-unit column (the quadrant of the cube of ``hw``
    pixels a side) and an auxiliary covariate (TCC, the score plus more
    noise). -> the CSV."""
    import csv

    import numpy as np
    rng = np.random.default_rng(SEED)
    ok = [r for r in rows if r.get("valid")]
    zt = np.asarray([[r[f"z_type_{d}"] for d in range(zt_dim)] for r in ok])
    score = ((zt - zt.mean(0)) / np.maximum(zt.std(0), 1e-12)
             @ rng.normal(size=zt_dim)) / np.sqrt(zt_dim)
    n = len(ok)
    extra = {"BALIVE": 20 + 8 * score + rng.normal(0, 2, n),
             "REMV": np.where(rng.random(n) < 0.6, 0.0,
                              np.exp(score + rng.normal(0, 0.3, n))),
             "TCC": 50 + 10 * score + rng.normal(0, 10, n)}
    half = hw // 2
    path = tmp / "fia_plots.csv"
    keys = list(ok[0]) + list(extra) + ["UNITCD"]
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=keys)
        w.writeheader()
        for i, r in enumerate(ok):
            w.writerow({**r, **{k: float(v[i]) for k, v in extra.items()},
                        "UNITCD": 2 * (r["pixel_row"] // half)
                        + r["pixel_col"] // half})
    return path


def _printed(fn, argv):
    """A CLI's ``main`` with its standard output captured -> (the lines it
    printed, seconds, K1's launches); the lines go on to standard error."""
    import contextlib
    import io
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            _, sec, k1 = _timed(fn, argv)
    finally:
        sys.stderr.write(buf.getvalue())
    return buf.getvalue().splitlines(), sec, k1


def clustering_k1_vs_plain(ckpt: Path, bpath: Path,
                           device: str = "cuda") -> dict:
    """The clustering CLIs' type forward (``frozen.make_encode_fns``'
    ``encode_type``, as ``eval.gmm`` runs it) on their first batch, 4 train
    patches of 128, with K1 and with its plain version swapped in: z_type
    within SERVE_REL_BOUND relative, K1 launched. -> the shape and type K1
    was given, its launches and the relative error."""
    from forest_tpu_torch.data import parse_bindings
    from forest_tpu_torch.data.feature_builder import FeatureBuilder
    from forest_tpu_torch.data.frl_dataset import ForestDatasetV2
    from forest_tpu_torch.eval import frozen
    from forest_tpu_torch.models import spatial
    from forest_tpu_torch.ops import smoothing as sm

    bindings = parse_bindings(str(bpath))
    fb = FeatureBuilder(bindings)
    ds = ForestDatasetV2(bindings, split="train", patch_size=128,
                         split_block_size=(4, 4))
    encode_type = frozen.make_encode_fns(
        frozen.load_frozen_model(ckpt, device), fb)[0]
    batch = frozen.batch_to_device(ds.load_batch(list(range(4))), device)
    seen = []

    def spy(x, *a, **k):
        seen.append([list(x.shape), str(x.dtype).replace("torch.", "")])
        return sm.bank_mix(x, *a, **k)

    spatial.bank_mix = spy
    try:
        reset_launches()
        kernel = encode_type(batch).float()
        launches = read_launches()["bank_mix_fwd"]
        spatial.bank_mix = sm.bank_mix_reference
        plain = encode_type(batch).float()
    finally:
        spatial.bank_mix = sm.bank_mix
    rel = float((kernel - plain).abs().max()
                / plain.abs().max().clamp_min(1e-12))
    res = {"k1_input": seen[0], "k1_calls": len(seen),
           "launches": launches, "rel_err_vs_plain": rel}
    if not rel <= SERVE_REL_BOUND or (device == "cuda" and not launches):
        raise AssertionError(f"clustering K1 vs plain (bound "
                             f"{SERVE_REL_BOUND}): {res}")
    return res


def landscape_reservoir(ckpt: Path, bpath: Path, device: str = "cuda",
                        capacity: int = 500_000, seed: int = 42):
    """The landscape CLI's first pass at its defaults, as it runs it ->
    (the z_type of the reservoir it fits, the pixels it saw)."""
    import numpy as np

    from forest_tpu_torch.data import parse_bindings
    from forest_tpu_torch.data.feature_builder import FeatureBuilder
    from forest_tpu_torch.data.frl_dataset import ForestDatasetV2
    from forest_tpu_torch.data.samplers import ReservoirSampler
    from forest_tpu_torch.eval import frozen
    from forest_tpu_torch.eval import landscape_categories as lc

    bindings = parse_bindings(str(bpath))
    fb = FeatureBuilder(bindings)
    ds = ForestDatasetV2(bindings, split="train", patch_size=128,
                         split_block_size=(4, 4), min_aoi=0.3)
    model = frozen.load_frozen_model(ckpt, device)
    phase_feature = getattr(model, "phase_feature", "phase_ccdc")
    keep = set(bindings.groups_for_features(
        ["type_encoder_input", phase_feature, "ysfc"])) | {"static_mask"}
    rs, n_seen = ReservoirSampler(capacity, seed=seed), 0
    for b in lc.stream_pixels(lc.make_extract_fn(model, fb), ds, 4, None,
                              keep, device):
        rs.add(np.concatenate([b["z_type"], b["summary"],
                               b["tvar"][:, None]], axis=1))
        n_seen += len(b["z_type"])
    return rs.sample()[:, :model.z_type_dim], n_seen


def cluster_card_vs_cpu(z_type, fia_z, device: str = "cuda") -> dict:
    """One GMM fit (diag, K 16, on CARD_VS_CPU_ROWS rows of the landscape
    reservoir's z_type), one KMeans fit (K 5, 10 inits) and one HDBSCAN run
    (min 20) on the FIA points' standardised z_type, on the card and on the
    CPU from the same host draws: labels equal, the GMM's iterations equal,
    its parameters and the centres within CARD_VS_CPU_REL relative. The
    check where a kernel's plain version would stand. -> seconds each."""
    import numpy as np

    from forest_tpu_torch.eval import cluster as cl
    x = z_type[np.random.default_rng(SEED).choice(
        len(z_type), min(CARD_VS_CPU_ROWS, len(z_type)), replace=False)]
    fz = (fia_z - fia_z.mean(0)) / np.maximum(fia_z.std(0, ddof=1), 1e-12)
    runs = {"gmm": lambda dev: cl.GaussianMixture(
                16, covariance_type="diag", random_state=SEED, max_iter=200,
                device=dev).fit(x),
            "kmeans": lambda dev: cl.KMeans(5, n_init=10, random_state=SEED,
                                            device=dev).fit(fz),
            "hdbscan": lambda dev: cl.HDBSCAN(20, 20, device=dev).fit(fz)}
    res, problems = {}, []
    for name, run in runs.items():
        out, secs = {}, {}
        for dev in ("cpu", device):
            t0 = time.perf_counter()
            out[dev] = run(dev)
            secs[dev] = time.perf_counter() - t0
        cpu, card = out["cpu"], out[device]
        labels = (cpu.predict(x), card.predict(x)) if name == "gmm" else (
            cpu.labels_, card.labels_)
        if not np.array_equal(*labels):
            problems.append(f"{name}: labels differ in "
                            f"{int((labels[0] != labels[1]).sum())} rows")
        rel = 0.0
        for attr in {"gmm": ("weights_", "means_", "covariances_"),
                     "kmeans": ("cluster_centers_",), "hdbscan": ()}[name]:
            a, b = getattr(cpu, attr), getattr(card, attr)
            rel = max(rel, float(np.abs(a - b).max()
                                 / max(np.abs(a).max(), 1e-300)))
        if not rel <= CARD_VS_CPU_REL:
            problems.append(f"{name}: parameters {rel} apart")
        if name == "gmm" and cpu.n_iter_ != card.n_iter_:
            problems.append(f"gmm: {cpu.n_iter_} vs {card.n_iter_} "
                            "iterations")
        res[name] = {"card_s": secs[device], "cpu_s": secs["cpu"],
                     "max_rel_diff": rel,
                     "clusters": int(len(set(labels[1].tolist())
                                         - {-1}))}
        if name == "gmm":
            res[name]["n_iter"] = card.n_iter_
    if problems:
        raise AssertionError(f"clustering card vs cpu: {problems}")
    return res


def clustering_tools_and_check(tmp: Path, device: str = "cuda") -> dict:
    """Phase 16: the clustering and FIA CLIs as a user runs them, on phase
    14's 1536 x 1536 cube and last checkpoint, each with the launch counts
    set to 0 just before it and read just after. (a) ``eval.gmm`` at its
    defaults (patches of 128, capacity 100,000, components 4 8 16 24 32)
    with the EVT column: a best K among them, finite BIC, labels for every
    sampled pixel, K1 launched on every batch, and K1 held to its plain
    version on gmm's first batch (clustering_k1_vs_plain); (b)
    ``eval.landscape_categories`` at its defaults (500,000 pixels, K 5-50
    step 5, 3 inits, silhouette on 20,000) but DYNAMIC_VAR_THRESHOLD:
    ``taxonomy.json`` and the pickles, a phase sweep per dynamic cluster
    and the second pass over the same batches; the reservoir drawn again
    as the CLI drew it (landscape_reservoir) falls in the type clusters in
    the taxonomy's numbers; then one GMM fit at GMM_TIMED_K on those
    500,000 pixels, timed alone; (c)
    ``embed_locations`` on FIA_POINTS points inside the AOI and forest,
    then ``eval.fia`` with each of its four analyses on that CSV
    (fia_table): finite tables; (d) cluster_card_vs_cpu. -> the
    readings."""
    import numpy as np

    from forest_tpu_torch.data import zarrlite as zl
    from forest_tpu_torch.data.frl_dataset import ForestDatasetV2
    from forest_tpu_torch.data import parse_bindings
    from forest_tpu_torch.eval import embed_locations, fia, gmm
    from forest_tpu_torch.eval import landscape_categories as lc
    from forest_tpu_torch.eval.cluster import GaussianMixture
    from forest_tpu_torch.training.checkpointing import load_state_raw

    ckpt = tmp / "runs" / "frl_v1" / "checkpoints" / "encoder_last.msgpack"
    bpath = tmp / "bindings.yaml"
    zt_dim = load_state_raw(ckpt)[1]["model_config"]["model"]["z_type_dim"]
    common = ["--checkpoint", str(ckpt), "--bindings", str(bpath)]
    if device != "cuda":
        common += ["--device", device]
    on_card = device == "cuda"
    res, problems = {}, []

    def batches(split, patch, min_aoi):
        ds = ForestDatasetV2(parse_bindings(str(bpath)), split=split,
                             patch_size=patch, split_block_size=(4, 4),
                             min_aoi=min_aoi)
        return -(-len(ds) // 4)

    # (a) the GMM sweep by BIC against EVT
    lines, sec, k1 = _printed(gmm.main, common + [
        "--output", str(tmp / "gmm.npz"),
        "--evt-source", "static_categorical.evt"])
    summary, npz = json.loads(lines[-1]), np.load(tmp / "gmm.npz")
    n_b = batches("train", 128, 0.3)
    if summary["best_k"] not in (4, 8, 16, 24, 32) or not all(
            np.isfinite(v) for v in summary["bic"].values()) or \
            npz["labels"].shape != (summary["n_samples"],) or \
            not 0 <= summary["nmi"] <= 1:
        problems.append(f"gmm: {summary}")
    if on_card and k1 < n_b:
        problems.append(f"gmm: {n_b} batches launched K1 {k1}")
    res["gmm"] = {"seconds": sec, "k1_launches": k1, "batches": n_b,
                  "pixels_fit": summary["n_samples"],
                  "best_k": summary["best_k"], "nmi": summary["nmi"],
                  "purity": summary["purity"],
                  "k1_vs_plain": clustering_k1_vs_plain(ckpt, bpath,
                                                        device)}

    # (b) the landscape taxonomy, both passes
    odir = tmp / "taxonomy"
    lines, sec, k1 = _printed(lc.main, common + [
        "--output-dir", str(odir),
        "--dynamic-var-threshold", DYNAMIC_VAR_THRESHOLD])
    tj = json.loads((odir / "taxonomy.json").read_text())
    with open(odir / "type_gmm.pkl", "rb") as f:
        type_pkl = pickle.load(f)
    # the reservoir again, as the CLI drew it: its pixels fall in the
    # taxonomy's clusters in the same numbers
    z500, n_seen = landscape_reservoir(ckpt, bpath, device)
    sizes = np.bincount(type_pkl["gmm"].predict(z500),
                        minlength=tj["k_type"]).tolist()
    dyn = [k for k, c in tj["clusters"].items() if c["is_dynamic"]]
    if tj["n_pixels_fit"] != len(z500) or not dyn or \
            tj["k_type"] not in range(5, 51, 5) or \
            not all((odir / f"phase_gmm_{k}.pkl").is_file() for k in dyn) \
            or sizes != [tj["clusters"][str(k)]["n_type_pixels"]
                         for k in range(tj["k_type"])] or \
            not any("pass 2" in ln for ln in lines):
        problems.append(f"landscape: {tj}, sizes {sizes}")
    n_b = batches("train", 128, 0.3)
    if on_card and k1 < 2 * n_b:
        problems.append(f"landscape: {n_b} batches x 2 passes launched K1 "
                        f"{k1}")
    t0 = time.perf_counter()
    one = GaussianMixture(GMM_TIMED_K, covariance_type="diag",
                          max_iter=200, random_state=SEED,
                          device=device).fit(z500)
    fit_s = time.perf_counter() - t0
    res["landscape"] = {
        "seconds": sec, "k1_launches": k1, "batches_per_pass": n_b,
        "passes": 2, "pixels_seen": n_seen,
        "pixels_fit": tj["n_pixels_fit"], "k_type": tj["k_type"],
        "dynamic_clusters": tj["n_dynamic_clusters"],
        "k_phase": {k: tj["clusters"][k]["k_phase"] for k in dyn},
        "q90_temporal_var": sorted(c["q90_temporal_var"]
                                   for c in tj["clusters"].values()),
        "type_silhouette": type_pkl["silhouette_curve"],
        "timed_fit": {"rows": list(z500.shape), "k": GMM_TIMED_K,
                      "n_iter": one.n_iter_, "seconds": fit_s,
                      "ms_per_iter": 1e3 * fit_s / max(one.n_iter_, 1)}}

    # (c) FIA: points inside the AOI and forest, their embeddings, the
    # four analyses
    cube = zl.open_zarr(tmp / "cube.zarr")
    aoi = np.asarray(cube["aoi"]) > 0
    hw = aoi.shape[1]
    inside = np.flatnonzero(aoi & (np.asarray(
        cube["static/lcms/data/forest"]) > 0))
    pts = np.random.default_rng(SEED).choice(inside, FIA_POINTS,
                                             replace=False)
    locs = tmp / "fia_points.csv"
    np.savetxt(locs, np.stack([pts // hw, pts % hw], 1), fmt="%d",
               delimiter=",", header="row,col", comments="")
    rows, sec, k1 = _timed(embed_locations.main, common + [
        "--locations", str(locs), "--output", str(tmp / "fia_emb.csv"),
        "--patch-size", "256", "--evt-source", "static_categorical.evt"])
    table = fia_table(tmp, rows, zt_dim, hw)
    res["fia"] = {"embed_seconds": sec, "k1_launches": k1,
                  "points": len(rows)}
    runs = {"hierarchical": ["--target", "BALIVE"],
            "hdbscan": ["--target", "BALIVE"],
            "removals": ["--target", "REMV", "--transfer-target", "BALIVE",
                         "--aux-col", "TCC"],
            "probe_table": ["--target", "BALIVE"]}
    fia_dev = [] if on_card else ["--device", device]
    for name, extra in runs.items():
        lines, sec, _ = _printed(fia.main, [
            "--csv", str(table), "--analysis", name, "--unit-col", "UNITCD",
            "--report-dir", str(tmp / f"fia_{name}")] + extra + fia_dev)
        out = json.loads(lines[-1])
        vals = ([v for r in out["table"].values() for v in r.values()]
                if "table" in out else
                [out[k] for k in ("within_var", "pct_of_baseline")])
        if out["n_plots"] != FIA_POINTS or not all(np.isfinite(vals)):
            problems.append(f"fia {name}: {out}")
        res["fia"][name] = {"seconds": sec, **{
            k: v for k, v in out.items()
            if k in ("pct_of_baseline", "hdbscan_k", "min_pts",
                     "noise_frac", "n_fine_bins")}}
        if name == "removals":
            res["fia"][name]["pct_of_baseline"] = {
                k: r["pct_of_baseline"] for k, r in out["table"].items()}
    if problems:
        raise AssertionError(f"clustering tools: {problems}")

    # (d) the card's fits against the CPU's
    fz = np.asarray([[r[f"z_type_{d}"] for d in range(zt_dim)]
                     for r in rows if r.get("valid")])
    res["card_vs_cpu"] = cluster_card_vs_cpu(z500, fz, device)
    return res


# phase 17: the diagnostics tools and the reference-checkpoint import on
# phase 14's cube and checkpoint, then HDBSCAN at a size whose dense
# [N, N] float64 matrices (3 x 28.8 GB at N 60,000) no card holds
HDBSCAN_N, HDBSCAN_D, HDBSCAN_MIN = 60_000, 56, 40
HDBSCAN_PEAK_BOUND = 1 << 30
# An imported reference encoder runs in float32 (the reference's config has
# no compute dtype): K1 and its plain version differ by float32 sums in
# another order (F32_BOUND at the kernel), here through the gate's two
# convolutions; bound on max |diff| / max |ref|.
IMPORT_REL_BOUND = 1e-4
# The phase probe's observed targets are the data's float32 features (a
# transform, an affine and the whitening) in another order on the card than
# on the CPU, in float64 back to the data's scale.
DIAG_OBS_REL_BOUND = 1e-5


def diag_k1_vs_plain(model, fb, batch) -> dict:
    """``visualize``'s gate forward (``make_encode_gate``) on one patch with
    K1 and with its plain version swapped in: z_type and the gate within
    SERVE_REL_BOUND relative. -> the launches and both errors."""
    from forest_tpu_torch.eval.visualize import make_encode_gate
    from forest_tpu_torch.models import spatial
    from forest_tpu_torch.ops import smoothing as sm

    encode_gate = make_encode_gate(model, fb)
    reset_launches()
    kernel = [t.float() for t in encode_gate(batch)]
    launches = read_launches()["bank_mix_fwd"]
    spatial.bank_mix = sm.bank_mix_reference
    try:
        plain = [t.float() for t in encode_gate(batch)]
    finally:
        spatial.bank_mix = sm.bank_mix
    res = {"launches": launches, "shape": list(kernel[0].shape)}
    for name, k, p in zip(("z_type", "gate"), kernel, plain):
        res[f"{name}_rel_err_vs_plain"] = float(
            (k - p).abs().max() / p.abs().max().clamp_min(1e-12))
    on_card = next(iter(batch.values())).is_cuda
    if not max(res["z_type_rel_err_vs_plain"],
               res["gate_rel_err_vs_plain"]) <= SERVE_REL_BOUND or (
            on_card and not launches):
        raise AssertionError(f"visualize's gate forward, K1 vs plain "
                             f"(bound {SERVE_REL_BOUND}): {res}")
    return res


def forest_diag_card_vs_cpu(ckpt: Path, bpath: Path,
                            device: str = "cuda") -> dict:
    """``collect_forest_diag_records`` on the card and on the CPU from the
    same phase probe (fit on the card over two batches of the test split,
    as ``visualize --forest-diag`` fits it over eight) on the patch the
    CLI ranks first: the masks and ysfc_min equal, the observed target
    within DIAG_OBS_REL_BOUND and the prediction within SERVE_REL_BOUND of
    its largest magnitude (bf16 K1 against the CPU's plain bf16 path). Also
    K1 against its plain version on that patch's gate forward
    (diag_k1_vs_plain). -> the errors and the seconds on each side."""
    import numpy as np

    from forest_tpu_torch.data import parse_bindings
    from forest_tpu_torch.data.feature_builder import FeatureBuilder
    from forest_tpu_torch.data.frl_dataset import ForestDatasetV2
    from forest_tpu_torch.eval import frozen
    from forest_tpu_torch.eval import phase_probe as pp
    from forest_tpu_torch.eval import visualize as vis
    from forest_tpu_torch.eval.phase_diagnostics import _resolve_phase_target

    bindings = parse_bindings(str(bpath))
    fb = FeatureBuilder(bindings)
    ds = ForestDatasetV2(bindings, split="test", patch_size=256,
                         split_block_size=(4, 4))
    pick = vis.rank_patches_by_ysfc(ds)[0][0]
    out, secs, res = {}, {}, {}
    for dev in (device, "cpu"):
        model = frozen.load_frozen_model(ckpt, dev)
        enc_t, enc_p, _ = frozen.make_encode_fns(model, fb)
        if dev == device:
            res["k1_vs_plain"] = diag_k1_vs_plain(model, fb, (
                frozen.batch_to_device(ds.load_batch([pick]), dev)))
            tfeat = _resolve_phase_target(
                bindings, getattr(model, "phase_feature", "phase_ccdc"))
            targets_fn = frozen.make_phase_target_fn(fb, tfeat)

            def enc_phase_fn(batch, coords):
                ta, tm = targets_fn(batch, coords)
                return enc_p(batch, coords), ta, tm

            w, pre = pp.fit_phase_probe(enc_t, enc_phase_fn, ds,
                                        max_batches=2, device=dev)
        t0 = time.perf_counter()
        out[dev] = vis.collect_forest_diag_records(
            enc_t, enc_p, fb, ds, [pick], w, pre, tfeat, device=dev)[0]
        secs[dev] = time.perf_counter() - t0
    card, cpu = out[device], out["cpu"]
    problems = []
    for k, v in cpu.items():
        if not isinstance(v, np.ndarray):
            continue
        if k.startswith(("target_", "pred_")):
            rel = float(np.abs(card[k] - v).max()
                        / max(np.abs(v).max(), 1e-12))
            res[f"{k}_rel_err"] = rel
            bound = DIAG_OBS_REL_BOUND if k.startswith("target_") \
                else SERVE_REL_BOUND
            if not rel <= bound:
                problems.append(f"{k}: {rel} > {bound}")
        elif not np.array_equal(card[k], v, equal_nan=v.dtype != bool):
            problems.append(f"{k} differs")
    if problems:
        raise AssertionError(f"forest diag records card vs cpu: {problems}")
    res.update({"patch": pick, "target": tfeat, "card_s": secs[device],
                "cpu_s": secs["cpu"]})
    return res


def _numeric(cell: str):
    try:
        return int(cell)
    except ValueError:
        try:
            return float(cell)
        except ValueError:
            return None


def same_tables(card_dir: Path, cpu_dir: Path) -> dict:
    """Every CSV of two ``phase_diagnostics`` runs: the same rows, text and
    integer cells equal, each other cell within SERVE_REL_BOUND of
    max(1, the column's largest magnitude) (bf16 K1 against the CPU's plain
    bf16 path, through means, variance fractions, the probe's refit and
    quantiles of its predictions). ``ysfc_by_evt.csv`` reads no embedding,
    so it must be equal byte for byte. -> each table's largest scaled
    difference."""
    import csv

    res, problems = {}, []
    for path in sorted(cpu_dir.glob("*.csv")):
        other = card_dir / path.name
        if path.name == "ysfc_by_evt.csv":
            if other.read_bytes() != path.read_bytes():
                problems.append("ysfc_by_evt.csv differs")
            res[path.name] = 0.0
            continue
        with open(path) as f:
            ref = list(csv.DictReader(f))
        with open(other) as f:
            got = list(csv.DictReader(f))
        if len(got) != len(ref) or (ref and list(got[0]) != list(ref[0])):
            problems.append(f"{path.name}: rows or columns differ")
            continue
        worst = 0.0
        for col in (ref[0] if ref else ()):
            vals = [_numeric(r[col]) for r in ref]
            if any(v is None or isinstance(v, int) for v in vals):
                if [r[col] for r in got] != [r[col] for r in ref]:
                    problems.append(f"{path.name} {col} differs")
                continue
            scale = max(1.0, max(abs(v) for v in vals))
            worst = max(worst, max(abs(float(g[col]) - v) for g, v in
                                   zip(got, vals)) / scale)
        res[path.name] = worst
        if not worst <= SERVE_REL_BOUND:
            problems.append(f"{path.name}: {worst} > {SERVE_REL_BOUND}")
    if problems or not res:
        raise AssertionError(f"phase_diagnostics card vs cpu: {problems}")
    return res


def reference_state_dict_of(model) -> dict:
    """The port model's weights under the reference trainer's key names
    and layouts (the inverse of ``utils.torch_import``'s mapping: the
    encoder's Sequential slots, ``mix_backbone``'s gx / gy input blocks,
    ``gate_net`` slots, 1x1 Conv2d heads), with the smoothing block's
    constant buffers the importer skips. -> name -> tensor on the host."""
    import torch

    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    out, j = {}, 0
    stages = len(model.hparams["type_encoder_channels"])
    for i in range(stages):
        out[f"encoder.layers.{j}.weight"] = sd[f"encoder.conv_{i}.weight"]
        for leaf in ("weight", "bias"):
            out[f"encoder.layers.{j + 1}.{leaf}"] = \
                sd[f"encoder.norm_{i}.{leaf}"]
        j += 2 + (i < stages - 1)                  # the ReLU's slot
    mb = sd["spatial_conv.mix_backbone.weight"]
    out["spatial_conv.mix_backbone.0.weight"] = torch.cat(
        [mb[:, 0::2], mb[:, 1::2]], 1)
    out["spatial_conv.mix_backbone.0.bias"] = \
        sd["spatial_conv.mix_backbone.bias"]
    c = mb.shape[1] // 2
    out["spatial_conv.bank"] = torch.zeros(
        model.hparams["spatial_conv_num_directions"], c, 1, 3, 3)
    out["spatial_conv.sobel_x"] = out["spatial_conv.sobel_y"] = \
        torch.zeros(c, 1, 3, 3)
    renames = {"spatial_conv.gate_0.": "spatial_conv.gate_net.0.",
               "spatial_conv.gate_1.": "spatial_conv.gate_net.2.",
               "spatial_conv.mix_head_": "spatial_conv.mix_head_",
               "phase_tcn.block_": "phase_tcn.layers.",
               "phase_head.": "phase_head.",
               "phase_film.gamma_0.": "phase_film.gamma_network.0.",
               "phase_film.gamma_1.": "phase_film.gamma_network.2.",
               "phase_film.beta_0.": "phase_film.beta_network.0.",
               "phase_film.beta_1.": "phase_film.beta_network.2."}
    for k, v in sd.items():
        for old, new in renames.items():
            if k.startswith(old):
                if v.dim() == 2:                   # Linear -> 1x1 Conv2d
                    v = v[:, :, None, None]
                out[new + k[len(old):]] = v.clone()
    return out


def reference_import_and_check(ckpt: Path, bpath: Path,
                               device: str = "cuda") -> dict:
    """Phase 14's trained encoder written as the reference trainer writes
    a checkpoint (its weights under the reference's names, the model
    config in the reference's schema with ``latents``, the input widths),
    through ``utils.torch_import.main``: the imported params equal the
    trained ones bit for bit; the import loaded by
    ``frozen.load_frozen_model`` on the card encodes one test patch of 256
    with K1 and with its plain version, within IMPORT_REL_BOUND. -> the
    errors and the import's seconds."""
    import torch

    from forest_tpu_torch.data import parse_bindings
    from forest_tpu_torch.data.frl_dataset import ForestDatasetV2
    from forest_tpu_torch.eval import frozen
    from forest_tpu_torch.training.checkpointing import load_state_raw
    from forest_tpu_torch.utils import torch_import

    meta = load_state_raw(ckpt)[1]
    trained = frozen.load_frozen_model(ckpt, "cpu")
    m = meta["model_config"]["model"]
    ref_cfg = {"latents": {k: m[k] for k in ("z_type_dim", "z_phase_dim")},
               **{k: {kk: vv for kk, vv in m[k].items()
                      if kk != "compute_dtype"}
                  for k in ("type_encoder", "spatial_conv", "phase_tcn")},
               "type_projection": {"enabled": False}}
    for sec in ("type_encoder", "phase_tcn"):
        ref_cfg[sec]["dropout"] = ref_cfg[sec].pop("dropout_rate", 0.0)
    pt, out = ckpt.parent / "reference_encoder.pt", \
        ckpt.parent / "imported.msgpack"
    torch.save({"model_state_dict": reference_state_dict_of(trained),
                "model_config": ref_cfg, "epoch": 3,
                "type_in_channels": meta["type_in_channels"],
                "phase_in_channels": meta["phase_in_channels"]}, pt)
    t0 = time.perf_counter()
    torch_import.main(["--checkpoint", str(pt), "--output", str(out)])
    sec = time.perf_counter() - t0
    imported = frozen.load_frozen_model(out, device)
    want = trained.state_dict()
    same = all(torch.equal(v.cpu(), want[k])
               for k, v in imported.state_dict().items()) and \
        imported.state_dict().keys() == want.keys()
    ds = ForestDatasetV2(parse_bindings(str(bpath)), split="test",
                         patch_size=256, split_block_size=(4, 4))
    patch = {k: v[0] for k, v in ds.load_batch([0]).items()}
    reset_launches()
    (k_zt, k_zp), (p_zt, p_zp) = kernel_and_plain(out, bpath, patch, device)
    launches = read_launches()["bank_mix_fwd"]
    res = {"import_s": sec, "params_equal": same, "launches": launches,
           "compute_dtype": imported.hparams["spatial_conv_compute_dtype"]}
    for name, k, p in (("z_type", k_zt, p_zt), ("z_phase", k_zp, p_zp)):
        res[f"{name}_rel_err_vs_plain"] = float(
            abs(k - p).max() / max(abs(p).max(), 1e-12))
    if not same or not max(res["z_type_rel_err_vs_plain"],
                           res["z_phase_rel_err_vs_plain"]) \
            <= IMPORT_REL_BOUND or (device == "cuda" and not launches):
        raise AssertionError(f"reference import (bound "
                             f"{IMPORT_REL_BOUND}): {res}")
    return res


def hdbscan_at_scale(device: str = "cuda") -> dict:
    """HDBSCAN on HDBSCAN_N points of four seeded Gaussian blobs in
    HDBSCAN_D dimensions (min HDBSCAN_MIN) on the card: four clusters, the
    allocator's peak over the input below HDBSCAN_PEAK_BOUND. -> seconds,
    peak bytes, clusters and the noise share."""
    import numpy as np
    import torch

    from forest_tpu_torch.eval import cluster as cl
    rng = np.random.default_rng(SEED)
    x = np.concatenate([c + rng.normal(size=(HDBSCAN_N // 4, HDBSCAN_D))
                        for c in rng.normal(scale=6.0,
                                            size=(4, HDBSCAN_D))])
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    labels = cl.HDBSCAN(HDBSCAN_MIN, HDBSCAN_MIN, device=device).fit(
        x).labels_
    sec = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base if on_card else None
    res = {"n": HDBSCAN_N, "d": HDBSCAN_D, "min": HDBSCAN_MIN,
           "seconds": sec, "peak_bytes": peak,
           "dense_bytes": 3 * 8 * HDBSCAN_N ** 2,
           "clusters": len(set(labels.tolist()) - {-1}),
           "noise_frac": float((labels < 0).mean())}
    if res["clusters"] != 4 or (on_card and not peak < HDBSCAN_PEAK_BOUND):
        raise AssertionError(f"hdbscan at N {HDBSCAN_N}: {res}")
    return res


def diagnostics_tools_and_check(tmp: Path, device: str = "cuda") -> dict:
    """Phase 17: the diagnostics CLIs as a user runs them, on phase 14's
    1536 x 1536 cube and last checkpoint, each with the launch counts set
    to 0 just before it and read just after. (a) ``eval.visualize`` with
    ``--probe --forest-diag`` at its defaults (4 test patches of 256): it
    ends, reports a figure count (0 where matplotlib does not import), K1
    launched for each patch of its four per-patch families; then
    forest_diag_card_vs_cpu; (b) ``eval.phase_diagnostics --probe`` at its
    defaults (8 train patches of 256) on the card and again on the CPU: the
    same files, every CSV within same_tables' bound, the summaries'
    ``n_evt_classes`` and ``n_pixels_total`` equal; (c)
    reference_import_and_check; (d) hdbscan_at_scale. -> the readings."""
    from forest_tpu_torch.eval import phase_diagnostics, visualize

    t_start = time.perf_counter()
    ckpt = tmp / "runs" / "frl_v1" / "checkpoints" / "encoder_last.msgpack"
    bpath = tmp / "bindings.yaml"
    common = ["--checkpoint", str(ckpt), "--bindings", str(bpath)]
    dev_arg = [] if device == "cuda" else ["--device", device]
    res, problems = {}, []

    # (a) the figure sheets, both families
    lines, sec, k1 = _printed(visualize.main, common + dev_arg + [
        "--out", str(tmp / "visualize"), "--probe", "--forest-diag"])
    wrote = [ln for ln in lines if ln.startswith("wrote ")]
    skipped = sum("skipped the figure" in ln for ln in lines)
    if not wrote or (device == "cuda" and k1 < 4 * 4):
        problems.append(f"visualize: {wrote}, K1 {k1}")
    res["visualize"] = {"seconds": sec, "k1_launches": k1,
                        "figures": int(wrote[-1].split()[1]) if wrote
                        else None, "figures_skipped": skipped,
                        "card_vs_cpu": forest_diag_card_vs_cpu(ckpt, bpath,
                                                               device)}

    # (b) the per-EVT reports on the card and on the CPU
    runs = {}
    for dev in (device, "cpu"):
        out = tmp / f"phase_diagnostics_{dev}"
        lines, sec, k1 = _printed(phase_diagnostics.main, common + [
            "--out", str(out), "--probe", "--device", dev])
        runs[dev] = (out, sec, k1,
                     json.loads((out / "summary.json").read_text()))
    (cout, csec, ck1, csum), (pout, psec, _, psum) = runs[device], \
        runs["cpu"]
    names = sorted(p.name for p in cout.iterdir())
    if names != sorted(p.name for p in pout.iterdir()) or \
            "probe_r2_by_evt.csv" not in names or \
            (device == "cuda" and ck1 < 8):
        problems.append(f"phase_diagnostics: {names}, K1 {ck1}")
    for k in ("n_evt_classes", "n_pixels_total", "top_evt_codes"):
        if csum[k] != psum[k]:
            problems.append(f"phase_diagnostics {k}: {csum[k]} vs {psum[k]}")
    if problems:
        raise AssertionError(f"diagnostics tools: {problems}")
    res["phase_diagnostics"] = {
        "seconds": csec, "cpu_seconds": psec, "k1_launches": ck1,
        "files": names, "n_evt_classes": csum["n_evt_classes"],
        "n_pixels_total": csum["n_pixels_total"],
        "probe_r2_global_mean": [csum["probe_r2_global_mean"],
                                 psum["probe_r2_global_mean"]],
        "tables_vs_cpu": same_tables(cout, pout)}

    # (c) a reference checkpoint through the importer; (d) HDBSCAN
    res["reference_import"] = reference_import_and_check(ckpt, bpath, device)
    res["hdbscan"] = hdbscan_at_scale(device)
    res["seconds"] = time.perf_counter() - t_start
    return res


# ---------------------------------------------------------------------------
# phase 18: the cube builders on the card, on GeoTIFFs written here
# ---------------------------------------------------------------------------
CUBE_HW = 2048                 # 61.44 km square at 30 m
CUBE_YEARS = (2018, 2022)
CUBE_CHUNK = 256
CUBE_SMALL_HW = 512            # zarr_builder's and manifest_stack's grids
CUBE_K1_BATCH = 4              # patches of 256 through the encoder
CUBE_X0, CUBE_Y0 = 300000.0, 4300020.0      # UTM 17N
CUBE_UTM = ('PROJCS["WGS 84 / UTM zone 17N",GEOGCS["WGS 84",DATUM['
            '"WGS_1984",SPHEROID["WGS 84",6378137,298.257223563]],'
            'PRIMEM["Greenwich",0],UNIT["degree",0.0174532925199433]],'
            'PROJECTION["Transverse_Mercator"],'
            'PARAMETER["latitude_of_origin",0],'
            'PARAMETER["central_meridian",-81],'
            'PARAMETER["scale_factor",0.9996],'
            'PARAMETER["false_easting",500000],'
            'PARAMETER["false_northing",0],UNIT["metre",1],'
            'AUTHORITY["EPSG","32617"]]')
CUBE_REPROJECTED = "static/climate/data/ppt"
# The card's cube against the CPU's: the same arrays byte for byte off the
# projection; the reprojected band's float64 values within 1e-9 of its
# scale (trig may differ by an ulp between libm and the card), stored as
# each one's float16 rounding; statistics equal but for mean and std, both
# float64 sums in another order (1e-12 of the band's |mean| + std).
CUBE_REPROJ_REL = 1e-9
CUBE_MOMENT_REL = 1e-12
# source -> (layout name, arguments of data.tiff.write_tiff); the rest stay
# uncompressed strips, as the JAX package's writer leaves them. One float32
# annual source is LZW with the floating point predictor (GDAL's
# COMPRESS=LZW PREDICTOR=3).
CUBE_LAYOUTS = {
    "data/main/aoi.tif": ("lzw-predictor", dict(compression="lzw",
                                                predictor=2)),
    "data/soils/masks.tif": ("packbits", dict(compression="packbits")),
    "data/ccdc/ccdc_2018.tif": ("deflate-tiled", dict(
        compression="deflate", tile=(256, 256))),
    "data/ccdc/ccdc_2019.tif": ("deflate-fp-predictor", dict(
        compression="deflate", predictor=3)),
    "data/ccdc/ccdc_2020.tif": ("lzw-fp-predictor", dict(
        compression="lzw", predictor=3)),
    "data/ccdc/ccdc_2021.tif": ("deflate-fp-predictor", dict(
        compression="deflate", predictor=3)),
    "data/lcms/ysfc_tiles.tif": ("deflate-tiled", dict(
        compression="deflate", tile=(256, 256))),
    "data/topo/topo.tif": ("deflate-tiled", dict(
        compression="deflate", tile=(512, 512), bigtiff=True)),
}


def cube_config(hw: int) -> dict:
    """A tripartite dataset YAML of the reference schema on a ``hw`` grid
    at 30 m: per-year (with a fill mapping), multiband and per-band (VRT)
    annual groups, an irregular group, static continuous, categorical
    (clipped from a CONUS-style source) and mask groups, AOI and strata,
    and one static band in EPSG:4326 resampled bilinear."""
    y0, y1 = CUBE_YEARS
    x1, yb = CUBE_X0 + 30.0 * hw, CUBE_Y0 - 30.0 * hw
    chunk = {"y": CUBE_CHUNK, "x": CUBE_CHUNK}
    return {
        "dataset": {
            "name": "smoke", "out_zarr": {"path": "/out/cube.zarr"},
            "spatial": {"crs": {"wkt": CUBE_UTM}, "resolution": 30,
                        "transform": [30, 0, CUBE_X0, 0, -30, CUBE_Y0],
                        "bounds": {"xmin": CUBE_X0, "ymin": yb,
                                   "xmax": x1, "ymax": CUBE_Y0}},
            "dtype": {"continuous": "float16", "categorical": "int16",
                      "mask": "uint8"},
            "default_chunk": {"annual": dict(chunk, time=1),
                              "irregular": dict(chunk, time=1),
                              "static": chunk},
            "compressor": {"name": "blosc", "cname": "lz4", "clevel": 3,
                           "shuffle": 1},
            "time": {"continuous": {"start": y0, "end": y1}},
            "statistics": {"spatial_mask": "aoi", "embed_in_zarr": True,
                           "export_json": True, "export_csv": True},
            "reprojection": {"enabled": True,
                             "crs_match_mode": "projection",
                             "resolution_tolerance_m": 1.0,
                             "interpolation": "bilinear"}},
        "aoi": {"path": "/data/main/aoi.tif"},
        "strata": {"path": "/data/main/strata.tif"},
        "annual": [
            {"group": "ccdc", "path": "/data/ccdc/ccdc_{yyyy}.tif",
             "fill_value": {"source": -9999, "target": "na"},
             "data": {"bands": [{"id": "ndvi", "source_band": 1},
                                {"id": "nbr", "source_band": 2}]}},
            {"group": "lcms", "years": {"start": y0, "end": y1},
             "data": {"semantic_type": "categorical",
                      "bands": [{"id": "ysfc",
                                 "path": "/data/lcms/ysfc.vrt"}]}},
            {"group": "landsat", "path": "/data/mb/landsat.tif",
             "years": {"start": y0, "end": y1 + 2},
             "data": {"bands": [{"id": "swir", "source_band": 1}]}}],
        "irregular": [
            {"group": "naip", "path": "/data/naip/naip_{yyyy}.tif",
             "years": [y0, y0 + 2],
             "data": {"bands": [{"id": "NDVI", "source_band": 1}]}}],
        "static": [
            {"group": "topo", "path": "/data/topo/topo.tif",
             "data": {"bands": [{"id": "elevation", "source_band": 1},
                                {"id": "slope", "source_band": 2}]}},
            {"group": "evt",
             "path": "/data/landfire/EVT_CONUS/evt_CONUS.tif",
             "data": {"semantic_type": "categorical",
                      "bands": [{"id": "evt", "source_band": 1}]}},
            {"group": "soils", "path": "/data/soils/masks.tif",
             "mask": {"bands": [{"id": "dem_mask", "source_band": 1}]}},
            {"group": "climate", "path": "/data/climate/prism_4326.tif",
             "data": {"bands": [{"id": "ppt", "source_band": 1}]}}],
    }


def write_source(path: Path, plane, layout: dict, **geo) -> None:
    """One band in a GDAL export's ``layout`` (the arguments of
    data.tiff.write_tiff) under the geo tags data.raster.geo_tags gives
    ``geo``."""
    from forest_tpu_torch.data import raster as rio
    from forest_tpu_torch.data import tiff
    tiff.write_tiff(path, [plane], rio.geo_tags(**geo), **layout)


def _retile(path: Path, layout: dict) -> None:
    """The pages and geo tags of ``path`` written again in ``layout``."""
    from forest_tpu_torch.data import tiff
    with tiff.TiffFile(path) as tf:
        pages = [tf.read(i) for i in range(len(tf.pages))]
        tags = tf.pages[0]
    types = {33550: tiff.DOUBLE, 33922: tiff.DOUBLE, 34735: tiff.SHORT,
             34737: tiff.ASCII, 42113: tiff.ASCII}
    tiff.write_tiff(path, pages, {k: (t, tags[k]) for k, t in types.items()
                                  if k in tags}, **layout)


def write_cube_sources(root: Path, cfg: dict) -> dict:
    """Every source of ``cfg`` under ``root``: ``synthesize_sources``, then
    files rewritten in the layouts of CUBE_LAYOUTS, the categorical EVT
    source on twice the grid's extent (the builder clips it) and the climate
    band in EPSG:4326 covering the grid. -> {path: layout name}."""
    import numpy as np

    from forest_tpu_torch.data import build_zarr_v2 as bz
    from forest_tpu_torch.data import raster as rio
    from forest_tpu_torch.data import reproject as rpj
    from forest_tpu_torch.data import tiff

    written = bz.synthesize_sources(cfg, root, seed=SEED)
    layouts = {p: "none" for p in written if p.suffix == ".tif"}
    for rel, (name, layout) in CUBE_LAYOUTS.items():
        _retile(root / rel, layout)
        layouts[root / rel] = name
    spatial = bz.parse_spatial_config(cfg)
    h, w = spatial.shape
    gx0, gdx, gy0, gdy = spatial.grid_transform
    rng = np.random.default_rng(SEED)
    # EVT on [2h, 2w] centred on the grid: smooth classes from blobs
    coarse = rng.normal(size=(8, 2 * h // 64 + 1, 2 * w // 64 + 1))
    blobs = np.kron(coarse, np.ones((1, 64, 64)))[:, :2 * h, :2 * w]
    codes = np.asarray([7008, 7009, 7010, 7046, 7061, 7062, 9014, 9016],
                       np.int16)
    evt = codes[blobs.argmax(0)]
    evt_path = root / "data/landfire/EVT_CONUS/evt_CONUS.tif"
    tiff.write_tiff(evt_path, [evt], rio.geo_tags(
        (gx0 - (w // 2) * gdx, gdx, gy0 - (h // 2) * gdy, gdy),
        nodata=-32768, crs_wkt=spatial.crs_wkt), compression="deflate",
        predictor=2, tile=(256, 256))
    layouts[evt_path] = "deflate-tiled-predictor"
    # climate in EPSG:4326 with a margin of ten pixels around the grid
    lon, lat = rpj.transform_coords(
        32617, 4326, np.array([gx0 - 300.0, gx0 + gdx * w + 300.0]),
        np.array([gy0 + 300.0, gy0 + gdy * h - 300.0]))
    lon, lat = lon.numpy(), lat.numpy()
    ny, nx = h + h // 8, w + w // 8
    clim = (800 + np.cumsum(rng.normal(0, 1, (ny, nx)), 1) / 8).astype(
        np.float32)
    clim_path = root / "data/climate/prism_4326.tif"
    write_source(clim_path, clim, dict(compression="deflate", predictor=3),
                 transform=(lon[0], (lon[1] - lon[0]) / nx, lat[0],
                            (lat[1] - lat[0]) / ny), epsg=4326)
    layouts[clim_path] = "deflate-fp-predictor"
    return layouts


def decode_rates(layouts: dict) -> dict:
    """The port's decode of every source, by layout: MB decoded, seconds,
    MB/s (pixels only, from an open file)."""
    from forest_tpu_torch.data import tiff
    acc = {}
    for path, name in layouts.items():
        with tiff.TiffFile(path) as tf:
            t0 = time.perf_counter()
            nbytes = sum(tf.read(i).nbytes for i in range(len(tf.pages)))
            sec = time.perf_counter() - t0
        a = acc.setdefault(name, {"files": 0, "mb": 0.0, "seconds": 0.0})
        a["files"] += 1
        a["mb"] += nbytes / 1e6
        a["seconds"] += sec
    for a in acc.values():
        a["mb_per_s"] = a["mb"] / a["seconds"]
    return acc


def pil_check(layouts: dict) -> dict:
    """Whether PIL imports here; where it does, every source's pages
    decoded by PIL and held to the port's decode (the port never uses
    PIL: this is information about the machine)."""
    try:
        from PIL import Image
    except ImportError as e:
        return {"imports": False, "why": str(e)}
    import numpy as np

    from forest_tpu_torch.data import tiff
    pages = equal = 0
    for path in layouts:
        with tiff.TiffFile(path) as tf, Image.open(path) as im:
            for i in range(len(tf.pages)):
                im.seek(i)
                pages += 1
                equal += bool(np.array_equal(np.array(im), tf.read(i)))
    if equal != pages:
        raise AssertionError(f"PIL decodes {pages - equal} of {pages} "
                             "source pages otherwise than the port")
    return {"imports": True, "pages": pages, "equal": equal}


class _LogCapture:
    """The records of one logger while the context is open."""

    def __init__(self, name: str):
        import logging
        self.logger = logging.getLogger(name)
        self.records = []
        self.handler = logging.Handler()
        self.handler.emit = lambda r: self.records.append(r.getMessage())

    def __enter__(self):
        self.logger.addHandler(self.handler)
        self._level = self.logger.level
        self.logger.setLevel(min(self._level or 20, 20))
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)
        self.logger.setLevel(self._level)


def _cli_build(cfg_path: Path, root: Path, out: str, device: str) -> dict:
    """``python -m forest_tpu_torch.data.build_zarr_v2`` in this process ->
    its seconds and the timings it logged by layer."""
    from forest_tpu_torch.data import build_zarr_v2 as bz
    with _LogCapture("forest_tpu_torch.build_zarr_v2") as cap:
        t0 = time.perf_counter()
        bz.main([str(cfg_path), "--path-root", str(root), "--out", out,
                 "--device", device])
        sec = time.perf_counter() - t0
    line = [m for m in cap.records if m.startswith("build ")][-1]
    return {"seconds": sec, **json.loads(line.split(": ", 1)[1])}


def _walk_arrays(g, prefix=""):
    from forest_tpu_torch.data import zarrlite as zl
    for name in g.keys():
        item = g[name]
        path = f"{prefix}/{name}" if prefix else name
        if isinstance(item, zl.ZarrArray):
            yield path, item
        else:
            yield from _walk_arrays(item, path)


def _stats_within(a: dict, b: dict, rel: float) -> bool:
    if set(a) != set(b):
        return False
    sd = "std" if "std" in a else "sd"
    for k, v in a.items():
        if k in ("mean", "std", "sd"):
            if abs(b[k] - v) > rel * (abs(a["mean"]) + abs(a[sd])):
                return False
        elif isinstance(v, dict):
            if {str(x): y for x, y in v.items()} != \
                    {str(x): y for x, y in b[k].items()}:
                return False
        elif v != b[k] and not (v != v and b[k] != b[k]):
            return False
    return True


def same_cubes(card: Path, cpu: Path, skip=()) -> dict:
    """The card's cube against the CPU's: arrays byte for byte (but
    ``skip``), attrs equal but for the statistics, those within
    CUBE_MOMENT_REL; the statistics sidecars likewise. -> counts."""
    import numpy as np

    from forest_tpu_torch.data import zarrlite as zl
    a, b = zl.ZarrGroup(card), zl.ZarrGroup(cpu)
    arrays = dict(_walk_arrays(a))
    problems = []
    if sorted(arrays) != sorted(k for k, _ in _walk_arrays(b)):
        raise AssertionError("the card's and the CPU's cubes hold other "
                             "arrays")
    mb = 0.0
    for k, x in arrays.items():
        xa, ya = dict(x.attrs), dict(b[k].attrs)
        xs, ys = xa.pop("statistics", None), ya.pop("statistics", None)
        if xa != ya or (xs is not None and not _stats_within(
                xs, ys, CUBE_MOMENT_REL)):
            problems.append(f"{k} attrs or statistics")
        if k in skip:
            continue
        u, v = np.asarray(x[:]), np.asarray(b[k][:])
        mb += u.nbytes / 1e6
        if u.dtype != v.dtype or not np.array_equal(u.view(np.uint8),
                                                    v.view(np.uint8)):
            problems.append(f"{k} array")
    if dict(a.attrs) != dict(b.attrs):
        problems.append("root attrs")
    sa = json.loads(card.with_suffix(".stats.json").read_text())
    sb = json.loads(cpu.with_suffix(".stats.json").read_text())
    if sa.keys() != sb.keys() or not all(
            _stats_within(sa[k], sb[k], CUBE_MOMENT_REL) for k in sa):
        problems.append("stats.json")
    if problems:
        raise AssertionError(f"card vs CPU cube: {problems}")
    return {"arrays": len(arrays), "equal_bytes_mb": mb}


def reprojected_card_vs_cpu(root: Path, cfg: dict, card: Path,
                            cpu: Path, device: str = "cuda") -> dict:
    """The EPSG:4326 band's bilinear resampling on the card and on the
    CPU: float64 values within CUBE_REPROJ_REL of the band's scale, each
    cube storing its own values' float16 rounding."""
    import numpy as np
    import torch

    from forest_tpu_torch.data import build_zarr_v2 as bz
    from forest_tpu_torch.data import raster as rio
    from forest_tpu_torch.data import reproject as rpj
    from forest_tpu_torch.data import zarrlite as zl

    spatial = bz.parse_spatial_config(cfg)
    r = rio.read_band(root / "data/climate/prism_4326.tif")
    vals = {}
    for name, dev in (("card", device), ("cpu", "cpu")):
        t0 = time.perf_counter()
        v = rpj.align_to_grid(torch.from_numpy(r.data).to(dev).double(),
                              r.transform, spatial.grid_transform,
                              spatial.shape, src_epsg=4326, dst_epsg=32617,
                              resampling="bilinear")
        if dev == "cuda":
            torch.cuda.synchronize()
        vals[name] = (v.cpu().numpy(), time.perf_counter() - t0)
    (g, g_s), (c, c_s) = vals["card"], vals["cpu"]
    scale = float(np.nanmax(np.abs(c)))
    err = float(np.nanmax(np.abs(g - c)) / scale)
    stored = [np.asarray(zl.ZarrGroup(p)[CUBE_REPROJECTED][:])
              for p in (card, cpu)]
    own = [np.array_equal(s, v.astype(np.float16), equal_nan=True)
           for s, v in ((stored[0], g), (stored[1], c))]
    res = {"rel_err_vs_cpu": err, "nan_equal": bool(np.array_equal(
        np.isnan(g), np.isnan(c))), "stored_own_rounding": own,
        "stored_differ": int((stored[0].view(np.uint16)
                              != stored[1].view(np.uint16)).sum()),
        "card_s": g_s, "cpu_s": c_s}
    if not (err <= CUBE_REPROJ_REL and res["nan_equal"] and all(own)):
        raise AssertionError(f"reprojection card vs CPU: {res}")
    return res


def _small_zarr_builder(tmp: Path, device: str = "cuda") -> dict:
    """zarr_builder at CUBE_SMALL_HW on the card and on the CPU: npy, npz
    and GeoTIFF sources (a year glob, a nodata-keyed uint16 band in LZW,
    a bilinear resample from 15 m), scale and offset, categorical and mask
    bands; the two cubes equal."""
    import numpy as np
    import yaml

    from forest_tpu_torch.data import zarr_builder as zb

    base = tmp / "zarr_builder"
    base.mkdir()
    n = CUBE_SMALL_HW
    gt = (CUBE_X0, 30.0, CUBE_Y0, -30.0)
    rng = np.random.default_rng(SEED)
    np.save(base / "ndvi.npy", rng.random((3, n, n)).astype(np.float32))
    np.savez(base / "masks.npz", aoi=(rng.random((n, n)) > 0.2).astype(
        np.uint8))
    elev = rng.normal(300, 50, (n, n)).astype(np.float32)
    elev[0, :7] = -9999.0
    write_source(base / "elev.tif", elev, dict(compression="deflate",
                                                tile=(256, 256)),
                 transform=gt, nodata=-9999)
    u = ((np.arange(n * n, dtype=np.uint16) % 900) + 10).reshape(n, n)
    u[1, 1] = 65535
    write_source(base / "u16.tif", u, dict(compression="lzw", predictor=2),
                 transform=gt, nodata=65535)
    for y in (2020, 2021, 2022):
        write_source(base / f"code_{y}.tif",
                     rng.normal(3, 2, (n, n)).astype(np.float32),
                     dict(compression="packbits"), transform=gt)
    write_source(base / "fine.tif", rng.normal(
        size=(2 * n, 2 * n)).astype(np.float32),
        dict(compression="deflate", predictor=3),
        transform=(gt[0], 15.0, gt[2], -15.0))
    np.save(base / "evt.npy", rng.choice([7008, 7009, 7046, 9014],
                                         (n, n)).astype(np.int16))
    spec = {"output": "cube.zarr",
            "spatial": {"height": n, "width": n, "chunk_y": 256,
                        "chunk_x": 256},
            "time": {"start": 2020, "end": 2022}, "aoi": "masks.npz:aoi",
            "groups": [
                {"name": "topo", "kind": "static", "dtype": "float32",
                 "bands": [{"name": "elevation", "source": "elev.tif"},
                           {"name": "u", "source": "u16.tif"},
                           {"name": "fine", "source": "fine.tif",
                            "resample": "bilinear"}]},
                {"name": "scaled", "kind": "static", "dtype": "float16",
                 "bands": [{"name": "elev16", "source": "elev.tif",
                            "scale_factor": 0.01, "add_offset": 2.0}]},
                {"name": "ccdc", "kind": "annual", "dtype": "float16",
                 "bands": [{"name": "ndvi", "source": "ndvi.npy"}]},
                {"name": "codes", "kind": "annual", "dtype": "int16",
                 "fill_value": -1,
                 "bands": [{"name": "code", "source": "code_*.tif"}]},
                {"name": "evt", "kind": "static", "dtype": "int16",
                 "semantic_type": "categorical",
                 "bands": [{"name": "evt", "source": "evt.npy"}]}]}
    (base / "spec.yaml").write_text(yaml.safe_dump(spec))
    secs = {}
    for name, dev in (("card", device), ("cpu", "cpu")):
        spec_dev = dict(spec, output=f"cube_{name}.zarr")
        (base / f"spec_{name}.yaml").write_text(yaml.safe_dump(spec_dev))
        t0 = time.perf_counter()
        zb.main(["--config", str(base / f"spec_{name}.yaml"), "--device",
                 dev])
        secs[name] = time.perf_counter() - t0
    same = same_cubes(base / "cube_card.zarr", base / "cube_cpu.zarr")
    return {"seconds": secs["card"], "cpu_seconds": secs["cpu"], **same}


def _small_manifest(tmp: Path, device: str = "cuda") -> dict:
    """manifest_stack at CUBE_SMALL_HW on the card and on the CPU: three
    years of two continuous and one categorical feature (PackBits sources
    on a larger extent, read boundlessly into the mask grid) and a 10 m
    NAIP raster pre-baked to 3 x 3 patches; the legacy cubes equal."""
    import numpy as np

    from forest_tpu_torch.data import manifest_stack as ms
    from forest_tpu_torch.data import raster as rio
    from forest_tpu_torch.data import zarrlite as zl

    base = tmp / "manifest"
    base.mkdir()
    n = CUBE_SMALL_HW
    grid = (CUBE_X0, 30.0, CUBE_Y0, -30.0)
    rng = np.random.default_rng(SEED)
    rows = []
    for y in (2019, 2020, 2021):
        for fid, kind in (("ndvi", "int"), ("nbr", "int"),
                          ("landcover", "cat")):
            a = rng.normal(size=(n + 8, n + 8)).astype(np.float32) \
                if kind == "int" else rng.integers(
                    0, 9, (n + 8, n + 8)).astype(np.float32)
            a[0] = -1
            p = base / f"{fid}_{y}.tif"
            write_source(p, a, dict(compression="packbits"),
                         transform=(grid[0] - 120, 30.0, grid[2] + 120,
                                    -30.0), nodata=-1)
            rows.append(f"{y},{kind},{p},{fid}")
    (base / "features.csv").write_text("year,kind,file_path,fid\n"
                                       + "\n".join(rows) + "\n")
    mask = (rng.random((n, n)) > 0.3).astype(np.float32)
    rio.write_geotiff(base / "mask.tif", mask, transform=grid)
    write_source(base / "naip.tif", rng.normal(
        size=(3 * n, 3 * n)).astype(np.float32),
        dict(compression="deflate", tile=(256, 256)),
        transform=(grid[0], 10.0, grid[2], -10.0))
    secs = {}
    for name, dev in (("card", device), ("cpu", "cpu")):
        t0 = time.perf_counter()
        _printed(ms.main, [
            "--features-csv", "features.csv", "--mask", "mask.tif",
            "--output", str(base / f"{name}.zarr"), "--end-years", "2021",
            "--window-len", "3", "--naip", "naip.tif", "--base-dir",
            str(base), "--chunk-yx", "128", "--patch-size", "128",
            "--device", dev])
        secs[name] = time.perf_counter() - t0
    a, b = zl.ZarrGroup(base / "card.zarr"), zl.ZarrGroup(base / "cpu.zarr")
    problems = [k for k in ("continuous", "categorical", "aoi_mask", "naip")
                if not np.array_equal(np.asarray(a[k][:]).view(np.uint8),
                                      np.asarray(b[k][:]).view(np.uint8))]
    fa, fb = a.attrs["feature_meta"], b.attrs["feature_meta"]
    for x, y in zip(fa["features"], fb["features"]):
        if x["kind"] == "cat" and x != y or x["kind"] == "int" and \
                not _stats_within(x["stats"], y["stats"], CUBE_MOMENT_REL):
            problems.append(x["name"])
    if a.attrs["naip_meta"] != b.attrs["naip_meta"]:
        problems.append("naip_meta")
    if problems:
        raise AssertionError(f"manifest_stack card vs CPU: {problems}")
    return {"seconds": secs["card"], "cpu_seconds": secs["cpu"],
            "features": len(fa["features"])}


def cube_bindings(cube: Path, stats_path: Path) -> dict:
    """Bindings of the built cube: its AOI, static continuous and
    categorical bands and the annual series; the type encoder's input is
    every static continuous band, normalised by the statistics the builder
    embedded (written to ``stats_path``)."""
    from forest_tpu_torch.data import zarrlite as zl
    root = zl.ZarrGroup(cube)
    static = [("elevation", "static/topo/data/elevation"),
              ("slope", "static/topo/data/slope"),
              ("ppt", CUBE_REPROJECTED)]
    annual = [("ndvi", "annual/ccdc/data/ndvi"),
              ("nbr", "annual/ccdc/data/nbr"),
              ("swir", "annual/landsat/data/swir")]
    stats = {"type_encoder_input": {}, "phase_ccdc": {}}
    for feat, group, chans in (("type_encoder_input", "static", static),
                               ("phase_ccdc", "annual", annual)):
        for name, src in chans:
            st = root[src].attrs["statistics"]
            stats[feat][f"{group}.{name}"] = {
                "mean": st["mean"], "sd": st["std"], "q25": st["q25"],
                "q50": st["q50"], "q75": st["q75"], "min": st["min"],
                "max": st["max"]}
    stats_path.write_text(json.dumps(stats))
    y0, y1 = CUBE_YEARS
    return {
        "version": "1.0", "name": "smoke_cube",
        "zarr": {"path": str(cube), "structure": "hierarchical"},
        "time_window": {"start": y0, "end": y1},
        "stats": {"compute": "never", "file": str(stats_path),
                  "stats": ["mean", "sd", "q25", "q50", "q75"]},
        "dataset": {
            "static_mask": {"type": "uint8", "dim": ["C", "H", "W"],
                            "channels": [{"name": "aoi", "source": "aoi"}]},
            "static": {"type": "float32", "dim": ["C", "H", "W"],
                       "channels": [{"name": n, "source": s}
                                    for n, s in static]},
            "static_categorical": {
                "type": "int16", "dim": ["C", "H", "W"],
                "channels": [{"name": "evt", "source": "static/evt/data/evt",
                              "fill_value": -1}]},
            "annual": {"type": "float32", "dim": ["C", "T", "H", "W"],
                       "channels": [{"name": n, "source": s}
                                    for n, s in annual]}},
        "features": {
            "type_encoder_input": {
                "dim": ["C", "H", "W"],
                "channels": {f"static.{n}": {"norm": "zscore"}
                             for n, _ in static}},
            "phase_ccdc": {
                "dim": ["C", "T", "H", "W"],
                "channels": {f"annual.{n}": {"norm": "zscore"}
                             for n, _ in annual}}},
    }


def cube_k1_vs_plain(cube: Path, tmp: Path, device: str = "cuda") -> dict:
    """One batch of CUBE_K1_BATCH patches of 256 of the built cube through
    ``ForestDatasetV2`` and ``FeatureBuilder`` into the v1
    ``RepresentationModel`` (seeded weights, the input width taken from the
    cube's bands): K1 counted from 0 on that forward, then held to its
    plain version (SERVE_REL_BOUND relative)."""
    import torch
    import yaml

    from forest_tpu_torch.data import parse_bindings
    from forest_tpu_torch.data.feature_builder import FeatureBuilder
    from forest_tpu_torch.data.frl_dataset import ForestDatasetV2
    from forest_tpu_torch.eval import frozen
    from forest_tpu_torch.models import representation as rep
    from forest_tpu_torch.models import spatial
    from forest_tpu_torch.ops import smoothing as sm

    bindings = parse_bindings(cube_bindings(cube, tmp / "cube_stats.json"))
    fb = FeatureBuilder(bindings)
    type_in = len(bindings.get_feature("type_encoder_input").channels)
    phase_in = len(bindings.get_feature("phase_ccdc").channels)
    cfg = yaml.safe_load((ROOT / "configs/frl_repr_model_v1.yaml")
                         .read_text())
    model = rep.from_config(cfg, type_in, phase_in)
    rep.init_parameters(model, torch.Generator().manual_seed(SEED))
    model = model.to(device).eval()
    ds = ForestDatasetV2(bindings, split=None, patch_size=256)
    t0 = time.perf_counter()
    batch = frozen.batch_to_device(ds.load_batch(list(range(CUBE_K1_BATCH))),
                                   device)
    load_s = time.perf_counter() - t0
    encode_type = frozen.make_encode_fns(model, fb)[0]
    reset_launches()
    kernel = encode_type(batch).float()
    launches = read_launches()["bank_mix_fwd"]
    spatial.bank_mix = sm.bank_mix_reference
    try:
        plain = encode_type(batch).float()
    finally:
        spatial.bank_mix = sm.bank_mix
    rel = float((kernel - plain).abs().max()
                / plain.abs().max().clamp_min(1e-12))
    res = {"patches": len(ds), "batch": CUBE_K1_BATCH, "type_in": type_in,
           "z_type": list(kernel.shape), "finite": bool(
               torch.isfinite(kernel).all()), "load_batch_s": load_s,
           "launches": launches, "rel_err_vs_plain": rel}
    if not (rel <= SERVE_REL_BOUND and res["finite"]) or (
            device == "cuda" and not launches):
        raise AssertionError(f"K1 on the built cube vs plain (bound "
                             f"{SERVE_REL_BOUND}): {res}")
    return res


def _same_report(a, b, rel: float = 1e-9) -> bool:
    """Two printed reports equal but for floats within ``rel`` (float64
    sums in another order on the card)."""
    import re
    num = re.compile(r"-?\d+\.\d+(?:e[-+]?\d+)?")
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        if num.sub("#", x) != num.sub("#", y):
            return False
        for u, v in zip(num.findall(x), num.findall(y)):
            if abs(float(u) - float(v)) > rel * max(abs(float(u)), 1e-300):
                return False
    return True


def cube_building_and_check(tmp: Path, device: str = "cuda") -> dict:
    """Phase 18: write the sources of cube_config(CUBE_HW) in the layouts
    GDAL exports use, time the port's decode by layout and report PIL;
    build the cube with ``build_zarr_v2`` on ``device`` and again on the
    CPU and hold the two together (same_cubes, reprojected_card_vs_cpu);
    run ``zarr_info`` on it on both; ``zarr_builder`` and
    ``manifest_stack`` on inputs of their own; K1 on a batch of the cube
    (cube_k1_vs_plain). -> the readings."""
    import yaml

    from forest_tpu_torch.data import zarr_info
    t_start = time.perf_counter()
    root = tmp / "cube_sources"
    cfg = cube_config(CUBE_HW)
    t0 = time.perf_counter()
    layouts = write_cube_sources(root, cfg)
    res = {"sources_s": time.perf_counter() - t0,
           "decode": decode_rates(layouts), "pil": pil_check(layouts)}
    cfg_path = tmp / "cube.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    res["build"] = {name: _cli_build(cfg_path, root, f"/{name}.zarr", dev)
                    for name, dev in (("card", device), ("cpu", "cpu"))}
    card, cpu = root / "card.zarr", root / "cpu.zarr"
    res["card_vs_cpu"] = same_cubes(card, cpu, skip=(CUBE_REPROJECTED,))
    res["reprojection"] = reprojected_card_vs_cpu(root, cfg, card, cpu,
                                                  device)
    for b in res["build"].values():
        b["write_mb_per_s"] = b["write_mb"] / b["write"]
    reports = {}
    for name, dev in (("card", device), ("cpu", "cpu")):
        (tmp / name).mkdir()
        lines, sec, _ = _printed(zarr_info.main, [
            str(card), "--cont-stats", "--cat-stats", "--sample-chunks",
            "0", "--export-counts", str(tmp / name / "counts.csv"),
            "--device", dev])
        reports[name] = ([ln.replace(str(tmp / name), "") for ln in lines],
                         sec)
    if not _same_report(reports["card"][0], reports["cpu"][0]) or \
            (tmp / "card/counts.csv").read_text() != \
            (tmp / "cpu/counts.csv").read_text():
        raise AssertionError("zarr_info on the card vs the CPU")
    res["zarr_info"] = {"seconds": reports["card"][1],
                        "cpu_seconds": reports["cpu"][1],
                        "lines": len(reports["card"][0])}
    res["zarr_builder"] = _small_zarr_builder(tmp, device)
    res["manifest_stack"] = _small_manifest(tmp, device)
    res["k1"] = cube_k1_vs_plain(card, tmp, device)
    res["seconds"] = time.perf_counter() - t_start
    return res


def build_vqvae_step(zarr, run_dir, device: str = "cuda"):
    """The VQ-VAE of configs/vae_v0.yaml over the cube at ``zarr`` as
    ``train_vqvae.train`` assembles it (schema, dataset, seeded weights,
    optimizer), and the first training batch on the device. -> a namespace:
    cfg, ds, model, state, train_step, class_weights, optimizer,
    host_batch, batch, weights."""
    from types import SimpleNamespace

    import torch

    from forest_tpu_torch.data.cube import LegacyCube
    from forest_tpu_torch.data.samplers import ChunkBatchSampler
    from forest_tpu_torch.data.schema import build_and_save_schema
    from forest_tpu_torch.data.vqvae_dataset import VQVAEDataset
    from forest_tpu_torch.models.vqvae import VQVAE, init_parameters
    from forest_tpu_torch.training import train_vqvae, vqvae_step
    from forest_tpu_torch.training.scheduler import cosine_lr

    cfg = train_vqvae.load_config(str(ROOT / "configs/vae_v0.yaml"), {})
    schema = Path(run_dir) / "schema.json"
    if not schema.exists():
        build_and_save_schema(
            LegacyCube(zarr), run_dir, cfg["batch_size"],
            VQ_TRAIN_STEPS, cfg["min_hits_per_epoch"], cfg["mass_coverage"],
            cfg["vocab_cap"])
    ds = VQVAEDataset(zarr, schema, split="train",
                      block_size=tuple(cfg["block_size"]))
    model = VQVAE(
        cont_dim=len(ds.cont_names),
        cat_vocab_sizes={n: ds.schema_cat[n]["num_ids"]
                         for n in ds.cat_names},
        naip_bands=ds.naip.shape[-1], num_timesteps=len(ds.ds["years"]),
        emb_dim=cfg["emb_dim"], codebook_size=cfg["codebook_size"],
        beta=cfg["beta"], hidden=cfg["hidden"], quantizer=cfg["quantizer"],
        cat_emb_dim=cfg["cat_emb_dim"], ema_decay=cfg["ema_decay"],
        ema_eps=cfg["ema_eps"])
    init_parameters(model, torch.Generator().manual_seed(SEED))
    model.to(device)
    cw = {n: torch.as_tensor(ds.class_weights_by_cat_name(n)).to(device)
          for n in ds.cat_names}
    opt = vqvae_step.make_optimizer(
        cosine_lr(cfg["lr"], VQ_TRAIN_EPOCHS * VQ_TRAIN_STEPS, cfg["min_lr"]),
        cfg["weight_decay"], cfg["clip_grad"])
    idx = next(iter(ChunkBatchSampler(ds.xy_by_chunk, cfg["batch_size"],
                                      drop_last=True, seed=SEED)))
    host_batch = ds.load_batch(idx)
    return SimpleNamespace(
        cfg=cfg, ds=ds, model=model, class_weights=cw, optimizer=opt,
        state=vqvae_step.init_train_state(model, opt),
        train_step=vqvae_step.make_train_step(model, opt, cw),
        host_batch=host_batch,
        batch=train_vqvae.host_to_device_batch(host_batch, device),
        # the annealer's weights once lambda_vq has reached its ceiling
        weights=train_vqvae.build_vq_annealer(cfg)(300))


def vqvae_train_and_check(device: str = "cuda") -> dict:
    """Phase 12: the VQ-VAE of configs/vae_v0.yaml through
    ``train_vqvae.main`` on the card, and its codebook export."""
    import numpy as np
    import torch

    from forest_tpu_torch.data.cube import build_synthetic_cube
    from forest_tpu_torch.data.samplers import ChunkBatchSampler
    from forest_tpu_torch.data.vqvae_dataset import VQVAEDataset
    from forest_tpu_torch.eval import export_codebook
    from forest_tpu_torch.ops import vq
    from forest_tpu_torch.training import train_vqvae

    with tempfile.TemporaryDirectory() as d:
        tmp = Path(d)
        zarr, run_dir = tmp / "cube.zarr", tmp / "run"
        t0 = time.perf_counter()
        build_synthetic_cube(zarr, height=256, width=256,
                             years=tuple(range(2017, 2022)), n_cont=8,
                             n_cat=2, n_naip=3, seed=SEED)
        cube_s = time.perf_counter() - t0

        # one step, same weights and batch: K4 against its plain version
        k = build_vqvae_step(zarr, tmp / "check", device)
        p = build_vqvae_step(zarr, tmp / "check", device)
        k_idx = k.model(k.batch).indices
        before = vq.vq_core.launches
        _, k_met = k.train_step(k.state, k.batch, k.weights)
        if vq.vq_core.launches != before + 1:
            raise AssertionError("a train step did not launch vq_core once")
        kernel_core = vq.vq_core
        vq.vq_core = vq.vq_core_reference
        try:
            p_idx = p.model(p.batch).indices
            _, p_met = p.train_step(p.state, p.batch, p.weights)
            if kernel_core.launches != before + 1:
                raise AssertionError("the plain step launched vq_core")
        finally:
            vq.vq_core = kernel_core
        torch.cuda.synchronize()
        k_loss, p_loss = (float(m["loss/total"]) for m in (k_met, p_met))
        cb_diff = (k.model.codebook - p.model.codebook).abs().max().item()
        res = {"kernel_step_loss_total": k_loss,
               "plain_step_loss_total": p_loss,
               "loss_rel_diff": abs(k_loss - p_loss) / abs(p_loss),
               "idx_equal": bool(torch.equal(k_idx, p_idx)),
               "codebook_max_abs_diff_after_ema": cb_diff}
        log(f"vqvae step, vq_core vs its plain version: {json.dumps(res)} "
            f"(bound {VQ_TRAIN_LOSS_REL_BOUND})")
        if not (res["idx_equal"]
                and res["loss_rel_diff"] <= VQ_TRAIN_LOSS_REL_BOUND
                and cb_diff <= 1e-5):
            raise AssertionError(f"the kernel step disagrees with the plain "
                                 f"step: {res}")

        # the main path: the CLI on the card
        reset_launches()
        t0 = time.perf_counter()
        train_vqvae.main([
            "--config", str(ROOT / "configs/vae_v0.yaml"), "--zarr",
            str(zarr), "--run-dir", str(run_dir), "--epochs",
            str(VQ_TRAIN_EPOCHS), "--steps-per-epoch", str(VQ_TRAIN_STEPS)])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches = read_launches()["vq_core"]

        history = json.loads((run_dir / "history.json").read_text())
        if [h["epoch"] for h in history] != list(range(VQ_TRAIN_EPOCHS)):
            raise AssertionError(f"history rows: {history}")
        bad = [(h["epoch"], m) for h in history for m, v in h.items()
               if not np.isfinite(v)]
        if bad:
            raise AssertionError(f"non-finite metrics: {bad}")
        first, last = history[0], history[-1]
        if not last["train/loss_total"] < first["train/loss_total"]:
            raise AssertionError(
                f"train/loss_total did not fall: "
                f"{[h['train/loss_total'] for h in history]}")
        if not all(h["train/perplexity"] > 1.0 for h in history):
            raise AssertionError("perplexity is not above 1")
        cfg = k.cfg
        ds_va = VQVAEDataset(zarr, run_dir / "schema.json", split="val",
                             block_size=tuple(cfg["block_size"]))
        val_steps = min(cfg.get("val_steps", 20), len(ChunkBatchSampler(
            ds_va.xy_by_chunk, cfg["batch_size"], drop_last=True,
            replacement_within_chunk=True)))
        steps = VQ_TRAIN_EPOCHS * VQ_TRAIN_STEPS
        expect = steps + VQ_TRAIN_EPOCHS * val_steps
        if launches != expect:
            raise AssertionError(
                f"{steps} train and {VQ_TRAIN_EPOCHS} x {val_steps} "
                f"validation steps launched vq_core {launches} times, not "
                f"{expect}")
        if not (run_dir / "ckpt" / "ckpt_last.msgpack").exists():
            raise AssertionError("no ckpt_last.msgpack")

        out = export_codebook.export(str(zarr), str(run_dir),
                                     device="cuda")
        z = np.load(out, allow_pickle=False)
        kk, tt = cfg["codebook_size"], 5
        shapes = {n: tuple(z[n].shape) for n in ("cont", "cats", "summary",
                                                 "usage", "canopy")}
        want = {"cont": (kk * tt, 8), "cats": (kk * tt, 2),
                "summary": (kk, 3), "usage": (kk,), "canopy": (kk,)}
        if shapes != want:
            raise AssertionError(f"export shapes {shapes} != {want}")
        if float(z["usage"].sum()) != steps * cfg["batch_size"]:
            raise AssertionError(
                f"code_usage sums to {z['usage'].sum()}, not "
                f"{steps} x {cfg['batch_size']}")
        if not np.isfinite(z["cont"]).all():
            raise AssertionError("non-finite decoded codebook")

        # a step's time on a resident batch (the CLI logs only epoch sums)
        times = []
        for _ in range(5 + 50):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            k.train_step(k.state, k.batch, k.weights)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        timed = sorted(times[5:])
        with torch.no_grad():
            x, c = k.model.encode(k.batch), k.model.codebook.detach()
        core_only_ms = cuda_ms(lambda: vq.vq_core(x, c))
        res.update({
            "cube_build_s": cube_s, "train_main_s": train_s,
            "train_steps": steps, "val_steps_per_epoch": val_steps,
            "launches": launches,
            "history": [{m: h[m] for m in (
                "epoch", "train/loss_total", "val/loss_total",
                "train/loss_vq", "train/perplexity", "epoch_time_s",
                "wait_s", "step_s", "steps_per_s")} for h in history],
            "step_ms_in_cli_mean": [1e3 * h["step_s"] / VQ_TRAIN_STEPS
                                    for h in history],
            "loader_wait_share": [h["wait_s"] / h["epoch_time_s"]
                                  for h in history],
            "step_ms_median": timed[len(timed) // 2],
            "step_ms_min": timed[0], "step_ms_max": timed[-1],
            "vq_core_ms_at_step_shape": core_only_ms,
            "codes_used": int((z["usage"] > 0).sum())})
    return res


SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")


def profile_steps(label: str, run_step, warm: int, steps: int,
                  top: int = 25) -> dict:
    """Profile ``steps`` calls of ``run_step``: device busy share of the
    window, the host synchronisations by the operator that made them, the
    device kernels by total time (kernel-level rows only) and the device
    time of every ``record_function`` range named "stage:...". -> the ms
    per step without the profiler (``wall_ms``) and the device's busy ms
    per step under it (``busy_ms``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warm):
        run_step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):      # the same steps without the profiler
        run_step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            run_step()
        torch.cuda.synchronize()
    kernels, syncs, sync_ops, stages = {}, {}, {}, {}
    for ev in prof.events():
        if ev.name.startswith("stage:"):    # a range, not a kernel
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                n, total = stages.get(ev.name, (0, 0.0))
                stages[ev.name] = (n + 1,
                                   total + ev.device_time_total / 1e3)
        elif ev.device_type == torch.autograd.DeviceType.CUDA:
            n, total = kernels.get(ev.name, (0, 0.0))
            kernels[ev.name] = (n + 1, total + ev.device_time / 1e3)
        elif ev.name in SYNC_CALLS:
            syncs[ev.name] = syncs.get(ev.name, 0) + 1
            op = ev.cpu_parent
            while op is not None and op.name in SYNC_CALLS:
                op = op.cpu_parent
            name = op.name if op is not None else "(no operator)"
            sync_ops[name] = sync_ops.get(name, 0) + 1
    # the synchronise that ends the profiled window is not the step's
    syncs["cudaDeviceSynchronize"] = syncs.get("cudaDeviceSynchronize", 0) - 1
    sync_ops["(no operator)"] = sync_ops.get("(no operator)", 0) - 1
    busy_ms = sum(t for _, t in kernels.values())
    n_launch = sum(n for n, _ in kernels.values())
    log(f"profile of {steps} {label} steps: device busy "
        f"{busy_ms / steps:.3f} ms per step in {n_launch / steps:.0f} "
        f"device kernels and copies; the same steps without the profiler "
        f"take {wall_ms / steps:.3f} ms each, so the device is busy "
        f"{100 * busy_ms / wall_ms:.1f} % of a step")
    log("host synchronisations per step: "
        + ", ".join(f"{name} {n / steps:.1f}" for name, n in syncs.items())
        + "; by operator: " + ", ".join(
            f"{name} {n / steps:.1f}" for name, n in
            sorted(sync_ops.items(), key=lambda kv: -kv[1])))
    for name, (n, t) in sorted(stages.items(), key=lambda kv: -kv[1][1]):
        log(f"  {t / steps:8.4f} ms/step of device time launched in "
            f"{name[6:]} ({n / steps:.0f} x)")
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1][1])
    ours = [kv for kv in ranked[top:] if any(
        word in kv[0] for word in ("bank_mix", "scatter_", "vq_"))]
    for name, (n, t) in ranked[:top] + ours:
        log(f"  {t / steps:8.4f} ms/step  {n / steps:6.1f} x  {name[:110]}")
    return {"wall_ms": wall_ms / steps, "busy_ms": busy_ms / steps}


def vq_core_split(generator, shapes=(VQ_SHAPE, VQ_STEP_SHAPE),
                  calls: int = 20) -> dict:
    """K4 as the VQ-VAE step calls it (no sum(q * x)), at each shape: the
    device time of each of its kernels per call (``torch.profiler``, kernel
    rows only), the launches per call, and the wrapper's time from call to
    return on an idle device (median)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from forest_tpu_torch.ops import vq
    out = {}
    for shape in shapes:
        x, c = vq_inputs(shape, generator)
        for _ in range(3):
            vq.vq_core(x, c)
        torch.cuda.synchronize()
        host = []
        for _ in range(calls):
            t0 = time.perf_counter()
            vq.vq_core(x, c)
            host.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
        # the profiler now and then loses a kernel record of a window (19
        # of 20 calls seen): a window whose records are not a whole number
        # per call is taken again, at most three times
        for attempt in range(1, 4):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    vq.vq_core(x, c)
                torch.cuda.synchronize()
            kernels = {}
            for ev in prof.events():
                if ev.device_type == torch.autograd.DeviceType.CUDA:
                    name = ev.name.replace("(anonymous namespace)::", "")
                    name = name.split("(")[0].split("<")[0].split(" ")[-1]
                    n, total = kernels.get(name, (0, 0.0))
                    kernels[name] = (n + 1, total + ev.device_time / 1e3)
            if sum(n for n, _ in kernels.values()) % calls == 0:
                break
        host.sort()
        out["x".join(map(str, shape))] = {
            "kernels_ms_per_call": {k: t / calls
                                    for k, (_, t) in kernels.items()},
            "device_ms_per_call": sum(t for _, t in kernels.values()) / calls,
            "launches_per_call": sum(n for n, _ in kernels.values()) / calls,
            "profile_windows": attempt,
            "host_ms_call_to_return": host[len(host) // 2]}
    log(f"vq_core split: {json.dumps(out)}")
    return out


def profile_vq_assign(generator, calls: int = 10) -> dict:
    """K5 (float32, bfloat16 operands) and K7 (float32 and bfloat16-rounded
    operands, x given as [D, N]) at the bench shape: each one's device time
    by kernel (``torch.profiler``, kernel rows only) and its time by CUDA
    events at N 8448 (one tile of 64 rows per SM), 131072 and 524288."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from forest_tpu_torch.ops import vq
    from forest_tpu_torch.ops import vq_variants as vv
    n, d, k = VQ_SHAPE
    c = torch.randn(k, d, device="cuda", generator=generator)
    ops = {"vq_assign f32": lambda x, xt: vq.vq_assign(x, c),
           "vq_assign bf16": lambda x, xt: vq.vq_assign(x, c, mxu_bf16=True),
           "vq_variant_cols f32": lambda x, xt: vv.make_assign_t(
               512, False, pre_transposed=True)(xt, c),
           "vq_variant_cols bf16-mxu": lambda x, xt: vv.make_assign_t(
               512, True, pre_transposed=True)(xt, c)}
    out = {}
    for rows in (8448, n, 4 * n):
        x = torch.randn(rows, d, device="cuda", generator=generator)
        xt = x.t().contiguous()
        for name, fn in ops.items():
            entry = out.setdefault(name, {"events_ms": {}})
            entry["events_ms"][rows] = cuda_ms(lambda: fn(x, xt))
            if rows != n:
                continue
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    fn(x, xt)
                torch.cuda.synchronize()
            kernels = {}
            for ev in prof.events():
                if ev.device_type == torch.autograd.DeviceType.CUDA:
                    kname = ev.name.split("(")[0].split("<")[0].split(" ")[-1]
                    kname = kname.split("::")[-1]
                    kernels[kname] = kernels.get(kname, 0.0) + \
                        ev.device_time / 1e3 / calls
            entry["kernels_ms_per_call"] = kernels
            entry["device_ms_per_call"] = sum(kernels.values())
        del x, xt
    log(f"vq_assign split: {json.dumps(out)}")
    return out


# the FRL step's stages whose device time --profile-training reports: the
# step module's functions, by name, and the model's two forwards
STEP_STAGES = ("extract_at_coords", "contrastive_loss_grouped",
               "variance_covariance_loss", "build_phase_pairs",
               "type_local_spectral_demean", "build_phase_neighborhood_batch",
               "phase_neighborhood_loss", "compute_phase_spread_ranking",
               "phase_recovery_discrimination_loss", "frobenius_type_leakage")


def _staged(fn, name: str):
    import torch

    def run(*a, **k):
        with torch.profiler.record_function("stage:" + name):
            return fn(*a, **k)
    return run


TYPE_WEIGHTS = ("spatial_infonce", "spectral_infonce", "vicreg_type")


def profile_training(device: str = "cuda", type_only: bool = False) -> None:
    """Where an FRL training step's time goes (every loss of
    DEFAULT_WEIGHTS, or with ``type_only`` the three type losses alone, as
    configs/frl_training_v1.yaml trains before its phase curriculum
    starts), with the forward's device time by stage: the backward runs on
    autograd's threads, outside the stages."""
    from forest_tpu_torch.training.representation import step as step_mod
    for name in STEP_STAGES:
        setattr(step_mod, name, _staged(getattr(step_mod, name), name))
    t = build_train_step(device)
    if type_only:
        t.weights = {k: (v if k in TYPE_WEIGHTS else 0.0)
                     for k, v in t.weights.items()}
    log(f"profiled weights: { {k: v for k, v in t.weights.items() if v} }")
    t.model.forward = _staged(t.model.forward, "type forward")
    t.model.forward_phase_at_locations = _staged(
        t.model.forward_phase_at_locations, "phase forward")

    def run():
        return t.train_step(t.state, t.batch, t.gen, t.weights, t.curriculum)
    times = profile_steps("train", run, warm=3, steps=2)
    log_step_mfu("train", run, times)


def log_step_mfu(label: str, run_step, times: dict) -> None:
    """One more call of ``run_step`` counted by ``utils.flops.step_flops``:
    print its GFLOP and its MFU against the H100's dense peaks over
    ``times``' ms per step and over the device's busy ms per step."""
    from forest_tpu_torch.utils import flops as fl
    n = fl.step_flops(run_step)
    log(f"{label} step: {n / 1e9:.3f} GFLOP (utils.flops.step_flops); over "
        f"{times['wall_ms']:.3f} ms a step "
        f"{json.dumps(fl.mfu_fields('step', n, times['wall_ms'] / 1e3))}; "
        f"over the device's busy {times['busy_ms']:.3f} ms "
        f"{json.dumps(fl.mfu_fields('busy', n, times['busy_ms'] / 1e3))} "
        f"({card_line()})")


def profile_vqvae(device: str = "cuda") -> None:
    """Where a VQ-VAE training step's time goes: the step on a resident
    batch, then the step with the batch's copy to the device before it, as
    the CLI runs it."""
    from forest_tpu_torch.data.cube import build_synthetic_cube
    from forest_tpu_torch.training import train_vqvae
    with tempfile.TemporaryDirectory() as d:
        zarr = Path(d) / "cube.zarr"
        build_synthetic_cube(zarr, height=256, width=256, seed=SEED)
        k = build_vqvae_step(zarr, Path(d) / "run", device)

        def run():
            return k.train_step(k.state, k.batch, k.weights)
        log_step_mfu("vqvae train",
                     run, profile_steps("vqvae train", run, warm=10,
                                        steps=20))
        profile_steps("vqvae train (with the batch's H2D copy)",
                      lambda: k.train_step(
                          k.state, train_vqvae.host_to_device_batch(
                              k.host_batch, device), k.weights),
                      warm=10, steps=20, top=5)


# phase 19: data parallel on the card. The machine this runs on has one H100
# and NCCL refuses two ranks on one card, so: (a) both CLIs under torchrun
# at world size 1 over NCCL, held to plain runs of the same seed; (b) two
# ranks sharing the card over gloo (chosen explicitly, on CUDA tensors),
# held to each other bit for bit and to a serial emulation in this process
DP_WORLD = 2
DP_FRL_STEPS = 2
DP_VQ_STEPS = 2
DP_VQ_BATCH = 64                 # rows a rank
DP_VQ_DEAD = (3, 17, 101)        # codes the EMA has given up on
DP_VQ_CLI_STEPS = 20
DP_ALLREDUCE_RUNS = 10
DP_TIMEOUT = 300
DP_MODEL_CONFIG = ROOT / "configs/frl_repr_model_v1.yaml"
DP_RANK_SCRIPT = ROOT / "chip_smoke.py"   # run with --dp-rank
# the environment a launcher leaves, which a process of this phase must not
# inherit
LAUNCH_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
              "GROUP_RANK", "ROLE_RANK", "MASTER_ADDR", "MASTER_PORT",
              "TORCHELASTIC_RUN_ID", "FOREST_TPU_COORDINATOR",
              "FOREST_TPU_NUM_PROCESSES", "FOREST_TPU_PROCESS_ID")


def _dp_env(**extra) -> dict:
    import os
    env = {k: v for k, v in os.environ.items() if k not in LAUNCH_ENV}
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    return {**env, **extra}


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_all(cmds: dict, cwd: Path) -> dict:
    """Run every command of ``cmds`` (name -> argv) at once to its end,
    each killed at DP_TIMEOUT, its output in ``cwd / <name>.log``; ->
    each one's seconds."""
    procs, t0 = {}, time.perf_counter()
    try:
        for name, cmd in cmds.items():
            with open(cwd / f"{name}.log", "w") as log_:
                procs[name] = subprocess.Popen(
                    [str(c) for c in cmd], cwd=cwd, env=_dp_env(),
                    stdout=log_, stderr=subprocess.STDOUT)
        seconds = {}
        while len(seconds) < len(procs):
            if time.perf_counter() - t0 > DP_TIMEOUT:
                raise AssertionError(f"{sorted(set(procs) - set(seconds))} "
                                     f"still running after {DP_TIMEOUT} s")
            for name, p in procs.items():
                if name not in seconds and p.poll() is not None:
                    seconds[name] = time.perf_counter() - t0
            time.sleep(0.1)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = {n: p.returncode for n, p in procs.items() if p.returncode != 0}
    if bad:
        raise AssertionError(f"{bad}:\n" + "\n".join(
            (cwd / f"{n}.log").read_text()[-4000:] for n in bad))
    return seconds


def _cli(module: str, torchrun: bool):
    """``python -m module``, or the same under ``torchrun --standalone
    --nproc_per_node 1``."""
    if torchrun:
        return [sys.executable, "-m", "torch.distributed.run",
                "--standalone", "--nproc_per_node", "1", "-m", module]
    return [sys.executable, "-m", module]


def _sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _seed_moments(state, seed: int = SEED) -> None:
    """AdamW's moments and count seeded alike in every process (as
    tests/test_torch_train_representation.py starts its runs): with zero
    moments Adam's first update is lr * sign(g), and a gradient that is
    rounding noise would take a random sign."""
    import torch
    g = torch.Generator().manual_seed(seed)
    for n in sorted(state.mu):
        mu, nu = state.mu[n], state.nu[n]
        mu.copy_(1e-2 * torch.randn(mu.shape, generator=g))
        nu.copy_(1e-5 + 1e-3 * torch.rand(nu.shape, generator=g))
    state.count = 3


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-12)


def _params_rel(got: dict, want: dict) -> float:
    """|got - want| / |want| over every parameter as one vector (L2). A
    gradient that is rounding noise (the FiLM shift's, the last norm's
    bias) can take either sign in two runs that add in another order, and
    Adam moves its parameter by the learning rate either way: a per-tensor
    bound would read that noise, the norm over the model does not."""
    import numpy as np
    d2 = w2 = 0.0
    for n, w in want.items():
        w = np.asarray(w, np.float64)
        d2 += float(np.sum((np.asarray(got[n], np.float64) - w) ** 2))
        w2 += float(np.sum(w ** 2))
    return (d2 / max(w2, 1e-30)) ** 0.5


def _same_history(got: list, want: list, label: str) -> dict:
    """Every loss within STEP_LOSS_REL_BOUND and the gradient norm within
    STEP_GNORM_REL_BOUND (relative, of values above 1e-6); the largest
    relative difference over every other key too, reported."""
    if [h["epoch"] for h in got] != [h["epoch"] for h in want]:
        raise AssertionError(f"{label}: epochs {got} against {want}")
    worst = {"loss": 0.0, "grad_norm": 0.0, "other": 0.0}
    for g, w in zip(got, want):
        for k, v in w.items():
            if k == "epoch" or k.endswith(("time_s", "wait_s", "step_s",
                                           "steps_per_s")):
                continue
            if abs(v) <= 1e-6 and abs(g[k]) <= 1e-6:
                continue
            kind = ("loss" if "loss_" in k else
                    "grad_norm" if k.endswith("grad_norm") else "other")
            worst[kind] = max(worst[kind], _rel(g[k], v))
    if worst["loss"] > STEP_LOSS_REL_BOUND or \
            worst["grad_norm"] > STEP_GNORM_REL_BOUND:
        raise AssertionError(f"{label}: {worst} (bounds "
                             f"{STEP_LOSS_REL_BOUND}, {STEP_GNORM_REL_BOUND})")
    return worst


def _ckpt_params(path: Path) -> dict:
    from forest_tpu_torch.training.checkpointing import load_state_raw
    from forest_tpu_torch.utils.flax_bridge import params_from_flax
    return {n: t.numpy() for n, t in
            params_from_flax(load_state_raw(path)[0]["params"]).items()}


def dp_world1_clis(tmp: Path, legacy: Path, device: str = "cuda") -> dict:
    """(a) ``torchrun --standalone --nproc_per_node 1`` of both CLIs (NCCL,
    a group of one: every collective runs) against the same CLI run by
    ``python -m`` without a group (a process of its own too, with the same
    defaults: TF32 convolutions among them), all four at once on the
    card: the FRL CLI on phase 14's cube, stats and
    configs with ``hardware.data_parallel: true`` for one epoch, the
    VQ-VAE CLI on ``legacy`` with configs/vae_v0.yaml and ``data_parallel:
    true`` for one epoch of DP_VQ_CLI_STEPS. History and final parameters
    within phase 8's bounds (the parameters: STEP_GNORM_REL_BOUND of their
    norm, ``_params_rel``)."""
    import json as _json

    import yaml

    training = yaml.safe_load((tmp / "training.yaml").read_text())
    training.setdefault("hardware", {})["data_parallel"] = True
    vq_cfg = yaml.safe_load((ROOT / "configs/vae_v0.yaml").read_text())
    vq_cfg["train_vqvae"]["data_parallel"] = True
    (tmp / "vae_dp.yaml").write_text(yaml.safe_dump(vq_cfg))
    out = {}
    for name in ("nccl", "plain"):
        t = dict(training, run=dict(training["run"],
                                    run_root=str(tmp / f"runs_dp_{name}")))
        (tmp / f"training_dp_{name}.yaml").write_text(yaml.safe_dump(t))

    def frl_argv(name):
        return ["--training", tmp / f"training_dp_{name}.yaml",
                "--bindings", tmp / "bindings.yaml", "--model-config",
                DP_MODEL_CONFIG, "--num-epochs", "1",
                "--phase-start-epoch", "0", "--device", device]

    def vq_argv(name):
        return ["--config", tmp / "vae_dp.yaml", "--zarr", legacy,
                "--run-dir", tmp / f"vq_dp_{name}", "--epochs", "1",
                "--steps-per-epoch", str(DP_VQ_CLI_STEPS), "--device",
                device]

    frl_m = "forest_tpu_torch.training.train_representation"
    vq_m = "forest_tpu_torch.training.train_vqvae"
    seconds = _run_all({
        "frl_nccl": _cli(frl_m, True) + frl_argv("nccl"),
        "frl_plain": _cli(frl_m, False) + frl_argv("plain"),
        "vq_nccl": _cli(vq_m, True) + vq_argv("nccl"),
        "vq_plain": _cli(vq_m, False) + vq_argv("plain")}, tmp)

    exp = {n: tmp / f"runs_dp_{n}" / training["run"]["experiment_name"]
           for n in ("nccl", "plain")}
    hist = {n: _json.loads((exp[n] / "history.json").read_text())
            for n in exp}
    out["frl"] = {
        "seconds": seconds["frl_nccl"],
        "plain_seconds": seconds["frl_plain"],
        "history_rel_err": _same_history(hist["nccl"], hist["plain"],
                                         "FRL CLI, NCCL world 1"),
        "params_rel_err": _params_rel(*(
            _ckpt_params(exp[n] / "checkpoints" / "encoder_last.msgpack")
            for n in ("nccl", "plain"))),
        "train_steps": hist["nccl"][0]["train/n_steps"]}
    vhist = {n: _json.loads((tmp / f"vq_dp_{n}" / "history.json")
                            .read_text()) for n in ("nccl", "plain")}
    out["vq"] = {
        "seconds": seconds["vq_nccl"],
        "plain_seconds": seconds["vq_plain"],
        "history_rel_err": _same_history(vhist["nccl"], vhist["plain"],
                                         "VQ-VAE CLI, NCCL world 1"),
        "params_rel_err": _params_rel(*(
            _ckpt_params(tmp / f"vq_dp_{n}" / "ckpt" / "ckpt_last.msgpack")
            for n in ("nccl", "plain")))}
    for k in ("frl", "vq"):
        if out[k]["params_rel_err"] > STEP_GNORM_REL_BOUND:
            raise AssertionError(f"{k} CLI at NCCL world 1: parameters "
                                 f"{out[k]['params_rel_err']:.3g} from the "
                                 "plain run's")
    return out


def _dp_frl(device: str, rows):
    """The v1 FRL step assembly of phase 8 (build_train_step) with seeded
    moments, and ``rows`` of its batch of 12."""
    t = build_train_step(device)
    _seed_moments(t.state)
    return t, {k: v[rows] for k, v in t.batch.items()}


def _dp_vq(legacy: Path, work: Path, device: str):
    """Phase 12's VQ-VAE assembly (build_vqvae_step) with seeded moments
    and DP_VQ_DEAD below the reseed threshold."""
    import torch
    k = build_vqvae_step(legacy, work, device)
    _seed_moments(k.state)
    size = k.state.vq_stats.cluster_size.clone()
    size[list(DP_VQ_DEAD)] = 1e-6
    k.state.vq_stats = k.state.vq_stats._replace(cluster_size=size)
    return k, torch.load(work / "dp_batches.pt", weights_only=False)


def _vq_batch(k, idx, device):
    from forest_tpu_torch.training import train_vqvae
    return train_vqvae.host_to_device_batch(k.ds.load_batch(idx), device)


def dp_rank_main(rank: int, world: int, port: int, work: Path,
                 device: str = "cuda") -> int:
    """``--dp-rank``: one of (b)'s ranks. gloo on the card's CUDA tensors;
    DP_FRL_STEPS FRL steps on its 6 rows of the batch of 12, then
    DP_VQ_STEPS VQ-VAE steps (EMA, reseed) on its DP_VQ_BATCH rows, every
    rank with the same generator seeds; the launches of K1-K4 per step,
    each step's time, the gloo all-reduce's time; -> rank_<r>.pt."""
    import torch

    from forest_tpu_torch.parallel import dp, hosts, local_rows, make_mesh

    torch.backends.cudnn.deterministic = True
    hosts.initialize(f"127.0.0.1:{port}", world, rank, backend="gloo",
                     device=device)
    mesh = make_mesh(device)
    dev = str(mesh.device)
    out = {"rank": rank, "device": dev, "backend": "gloo"}

    t, batch = _dp_frl(dev, local_rows(TRAIN_SHAPE[0], mesh))
    step = dp.make_dp_frl_step(t.process, t.optimizer, mesh)
    frl = {"metrics": [], "ms": [], "launches": []}
    for i in range(DP_FRL_STEPS):
        gen = torch.Generator(device=dev).manual_seed(SEED + i)
        reset_launches()
        _sync(dev)
        t0 = time.perf_counter()
        _, m = step(t.state, batch, gen, t.weights, t.curriculum)
        _sync(dev)
        frl["ms"].append(1e3 * (time.perf_counter() - t0))
        frl["launches"].append(read_launches())
        frl["metrics"].append({k: float(v) for k, v in m.items()})
    frl["params"] = {n: p.detach().cpu().clone() for n, p in
                     t.model.named_parameters()}
    grads = [torch.randn_like(p) for p in t.model.parameters()]
    ms = []
    for _ in range(DP_ALLREDUCE_RUNS):
        _sync(dev)
        t0 = time.perf_counter()
        dp.all_reduce_mean(grads, mesh.group)
        _sync(dev)
        ms.append(1e3 * (time.perf_counter() - t0))
    frl["allreduce_ms"] = sorted(ms)[len(ms) // 2]
    frl["allreduce_mb"] = sum(g.numel() for g in grads) * 4 / 1e6
    out["frl"] = frl
    del t, batch, step, grads
    if mesh.device.type == "cuda":
        torch.cuda.empty_cache()

    k, batches = _dp_vq(work / "legacy.zarr", work, dev)
    step = dp.make_dp_train_step(k.model, k.optimizer, mesh,
                                 k.class_weights, reseed_dead=True)
    rows = local_rows(DP_WORLD * DP_VQ_BATCH, mesh)
    vq = {"metrics": [], "ms": [], "launches": []}
    for i, idx in enumerate(batches):
        b = _vq_batch(k, idx[rows], dev)
        gen = torch.Generator(device=dev).manual_seed(SEED + 100 + i)
        reset_launches()
        _sync(dev)
        t0 = time.perf_counter()
        _, m = step(k.state, b, k.weights, generator=gen)
        _sync(dev)
        vq["ms"].append(1e3 * (time.perf_counter() - t0))
        vq["launches"].append(read_launches()["vq_core"])
        vq["metrics"].append({n: float(v) for n, v in m.items()})
    with torch.no_grad():
        vq["indices"] = k.model(b).indices.cpu().clone()
    vq["params"] = {n: p.detach().cpu().clone() for n, p in
                    k.model.named_parameters()}
    vq["vq_stats"] = [s.cpu().clone() for s in k.state.vq_stats]
    out["vq"] = vq
    hosts.sync()
    torch.save(out, work / f"rank_{rank}.pt")
    hosts.shutdown()
    return 0


def _sync_like_dp(m0: dict, m1: dict) -> dict:
    """dp.sync_metrics of two ranks' metrics, in float64."""
    from forest_tpu_torch.parallel.dp import _COUNT_METRICS
    return {k: (float(m0[k]) + float(m1[k])) / (1 if k in _COUNT_METRICS
                                                else 2) for k in m0}


def dp_emulate_frl(device: str = "cuda") -> dict:
    """(b)'s FRL steps serially in this process: each half's loss and
    gradients, averaged, counts summed, one update. -> per-step metrics,
    the parameters, and the plain step's ms on one half."""
    import torch

    from forest_tpu_torch.training.representation import train_step as ts
    halves = [slice(0, TRAIN_SHAPE[0] // 2),
              slice(TRAIN_SHAPE[0] // 2, TRAIN_SHAPE[0])]
    t, _ = _dp_frl(device, halves[0])
    names, params = zip(*t.model.named_parameters())
    metrics = []
    for i in range(DP_FRL_STEPS):
        got = []
        for r in halves:
            gen = torch.Generator(device=device).manual_seed(SEED + i)
            loss, m = t.process({k: v[r] for k, v in t.batch.items()}, gen,
                                t.weights, t.curriculum, True)
            g = torch.autograd.grad(loss, params, allow_unused=True)
            got.append((loss.detach(), m, [torch.zeros_like(p) if x is None
                                           else x for p, x in zip(params,
                                                                  g)]))
        grads = [(a + b) / 2 for a, b in zip(got[0][2], got[1][2])]
        loss = (got[0][0] + got[1][0]) / 2
        gnorm = ts.global_norm(grads)
        if bool(torch.isfinite(loss) & torch.isfinite(gnorm)):
            ts.apply_update(t.state, t.optimizer, dict(zip(names, grads)),
                            gnorm)
        t.state.step += 1
        m = _sync_like_dp(got[0][1], got[1][1])
        m["grad_norm"] = float(gnorm)
        metrics.append(m)
    params = {n: p.detach().cpu().clone()
              for n, p in t.model.named_parameters()}
    # the plain step on one half of the batch, alone on the card
    plain = ts.make_train_step(t.process, t.optimizer)
    batch = {k: v[halves[0]] for k, v in t.batch.items()}
    ms = []
    for i in range(3):
        gen = torch.Generator(device=device).manual_seed(SEED + i)
        _sync(device)
        t0 = time.perf_counter()
        plain(t.state, batch, gen, t.weights, t.curriculum)
        _sync(device)
        ms.append(1e3 * (time.perf_counter() - t0))
    return {"metrics": metrics, "params": params,
            "plain_step_ms": sorted(ms)[1]}


def dp_emulate_vq(work: Path, device: str = "cuda") -> dict:
    """(b)'s VQ-VAE steps serially in this process: each half's
    gradients averaged, counts and sums summed, the candidates
    concatenated in rank order, one update."""
    import torch

    from forest_tpu_torch.ops import vq as vq_ops
    from forest_tpu_torch.training import vqvae_step
    from forest_tpu_torch.training.representation import train_step as ts
    k, batches = _dp_vq(work / "legacy.zarr", work, device)
    names, params = zip(*k.model.named_parameters())
    metrics = []
    for i, idx in enumerate(batches):
        got = []
        for r in range(DP_WORLD):
            b = _vq_batch(k, idx[r * DP_VQ_BATCH:(r + 1) * DP_VQ_BATCH],
                          device)
            out = k.model(b)
            total, m = vqvae_step.vqvae_loss(out, b, k.class_weights,
                                             k.weights)
            g = torch.autograd.grad(total, params, allow_unused=True)
            got.append((out, {n: v.detach() for n, v in m.items()},
                        [torch.zeros_like(p) if x is None else x
                         for p, x in zip(params, g)]))
        grads = [(a + b_) / 2 for a, b_ in zip(got[0][2], got[1][2])]
        gnorm = ts.global_norm(grads)
        ts.apply_update(k.state, k.optimizer, dict(zip(names, grads)), gnorm)
        o0, o1 = got[0][0], got[1][0]
        with torch.no_grad():
            stats, cb = vq_ops.ema_codebook_update(
                k.state.vq_stats, k.model.codebook, o0.counts + o1.counts,
                o0.sums + o1.sums, decay=k.model.ema_decay,
                eps=k.model.ema_eps)
            cb, stats = vq_ops.reseed_dead_codes(
                cb, stats, torch.cat([o0.z_e, o1.z_e]),
                generator=torch.Generator(device=device).manual_seed(
                    SEED + 100 + i))
            k.model.codebook.copy_(cb)
        k.state.vq_stats = stats
        k.state.step += 1
        m = _sync_like_dp(got[0][1], got[1][1])
        m["grad_norm"] = float(gnorm)
        metrics.append(m)
    with torch.no_grad():
        idx = [k.model(_vq_batch(
            k, batches[-1][r * DP_VQ_BATCH:(r + 1) * DP_VQ_BATCH],
            device)).indices.cpu() for r in range(DP_WORLD)]
    return {"metrics": metrics, "indices": idx,
            "params": {n: p.detach().cpu().clone() for n, p in
                       k.model.named_parameters()},
            "vq_stats": [s.cpu().clone() for s in k.state.vq_stats]}


def _hold_steps(ranks: list, emu: dict, label: str) -> dict:
    """The ranks bit for bit equal to each other; rank 0 against the
    emulation: each step's loss within STEP_LOSS_REL_BOUND, its gradient
    norm within STEP_GNORM_REL_BOUND, the parameters within
    STEP_GNORM_REL_BOUND of their norm (``_params_rel``)."""
    import torch
    a, b = ranks
    for n in a["params"]:
        if not torch.equal(a["params"][n], b["params"][n]):
            raise AssertionError(f"{label}: the ranks differ in {n}")
    if a["metrics"] != b["metrics"]:
        raise AssertionError(f"{label}: the ranks' metrics differ")
    loss_key = "loss/total" if "loss/total" in a["metrics"][0] \
        else "loss_total"
    res = {"loss_rel_err": max(_rel(g[loss_key], w[loss_key]) for g, w in
                               zip(a["metrics"], emu["metrics"])),
           "grad_norm_rel_err": max(
               _rel(g["grad_norm"], w["grad_norm"])
               for g, w in zip(a["metrics"], emu["metrics"])),
           "params_rel_err": _params_rel(
               {n: v.numpy() for n, v in a["params"].items()},
               {n: v.numpy() for n, v in emu["params"].items()})}
    if res["loss_rel_err"] > STEP_LOSS_REL_BOUND or \
            res["grad_norm_rel_err"] > STEP_GNORM_REL_BOUND or \
            res["params_rel_err"] > STEP_GNORM_REL_BOUND:
        raise AssertionError(f"{label}: the ranks against the serial "
                             f"emulation: {res}")
    return res


def dp_two_ranks(work: Path, device: str = "cuda") -> dict:
    """(b) and (c): DP_WORLD ranks of ``chip_smoke.py --dp-rank`` on the
    one card over gloo, then the serial emulation here; K1, K2 and K3
    launched on every rank in every FRL step, K4 in every VQ-VAE step."""
    import torch

    from forest_tpu_torch.data.samplers import ChunkBatchSampler

    # the VQ-VAE's global batches: DP_WORLD x DP_VQ_BATCH rows each
    k = build_vqvae_step(work / "legacy.zarr", work, device)  # the schema
    it = iter(ChunkBatchSampler(k.ds.xy_by_chunk, DP_WORLD * DP_VQ_BATCH,
                                drop_last=True, seed=SEED))
    torch.save([next(it) for _ in range(DP_VQ_STEPS)],
               work / "dp_batches.pt")
    del k
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    port = _free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(DP_RANK_SCRIPT), "--dp-rank", str(r),
         str(DP_WORLD), str(port), str(work), device], cwd=work,
        env=_dp_env(LOCAL_RANK="0"), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(DP_WORLD)]
    try:
        logs = [p.communicate(timeout=DP_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ranks_s = time.perf_counter() - t0
    for r, (p, log_) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"rank {r} exited {p.returncode}:\n"
                                 f"{log_[-6000:]}")
    ranks = [torch.load(work / f"rank_{r}.pt", weights_only=False)
             for r in range(DP_WORLD)]
    missing = [(r["rank"], i, name) for r in ranks
               for i, n in enumerate(r["frl"]["launches"])
               for name in ("bank_mix_fwd", "bank_mix_bwd",
                            "scatter_add_rows") if n[name] <= 0]
    missing += [(r["rank"], i, "vq_core") for r in ranks
                for i, n in enumerate(r["vq"]["launches"]) if n <= 0]
    if missing and torch.device(device).type == "cuda":   # the CPU: plain
        raise AssertionError(f"steps that launched no kernel: {missing}")

    torch.backends.cudnn.deterministic = True
    try:
        t0 = time.perf_counter()
        emu_frl = dp_emulate_frl(device)
        emu_vq = dp_emulate_vq(work, device)
        emulation_s = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.deterministic = False
    res = {"ranks_seconds": ranks_s, "emulation_seconds": emulation_s,
           "frl": _hold_steps([r["frl"] for r in ranks], emu_frl,
                              "FRL, two gloo ranks"),
           "vq": _hold_steps([r["vq"] for r in ranks], emu_vq,
                             "VQ-VAE, two gloo ranks")}
    for r in ranks:
        if not torch.equal(torch.cat(emu_vq["indices"]).reshape(
                DP_WORLD, -1)[r["rank"]], r["vq"]["indices"]):
            raise AssertionError(f"VQ-VAE rank {r['rank']}: code indices "
                                 "differ from the emulation's")
    res["frl"].update(
        rank_step_ms=[r["frl"]["ms"] for r in ranks],
        plain_step_ms=emu_frl["plain_step_ms"],
        gloo_allreduce_ms=ranks[0]["frl"]["allreduce_ms"],
        allreduce_mb=ranks[0]["frl"]["allreduce_mb"])
    res["vq"]["rank_step_ms"] = [r["vq"]["ms"] for r in ranks]
    res["launches"] = {
        name: sum(n[name] for r in ranks for n in r["frl"]["launches"])
        for name in ("bank_mix_fwd", "bank_mix_bwd", "scatter_add_rows")}
    res["launches"]["vq_core"] = sum(n for r in ranks
                                     for n in r["vq"]["launches"])
    return res


def nccl_world1_allreduce_ms(device: str = "cuda") -> dict:
    """The gradient all-reduce of the v1 model (dp.all_reduce_mean, one
    buffer) over NCCL at world size 1 (gloo on the CPU), in this process:
    a group of one brought up and torn down here."""
    import torch

    from forest_tpu_torch.models import representation as rep
    from forest_tpu_torch.parallel import dp, hosts, make_mesh
    import yaml
    cfg = yaml.safe_load(DP_MODEL_CONFIG.read_text())
    model = rep.from_config(cfg, 4, 3).to(device)
    hosts.initialize(f"127.0.0.1:{_free_port()}", 1, 0, device=device)
    try:
        mesh = make_mesh(device)
        grads = [torch.randn_like(p) for p in model.parameters()]
        dp.all_reduce_mean(grads, mesh.group)
        ms = []
        for _ in range(DP_ALLREDUCE_RUNS):
            _sync(device)
            t0 = time.perf_counter()
            dp.all_reduce_mean(grads, mesh.group)
            _sync(device)
            ms.append(1e3 * (time.perf_counter() - t0))
    finally:
        hosts.shutdown()
    return {"ms": sorted(ms)[len(ms) // 2],
            "mb": sum(g.numel() for g in grads) * 4 / 1e6}


def data_parallel_and_check(tmp: Path, device: str = "cuda") -> dict:
    """Phase 19 on phase 14's cube, stats and configs in ``tmp``: (a)
    dp_world1_clis, (b) and (c) dp_two_ranks, and the all-reduce's time
    over NCCL at world size 1."""
    from forest_tpu_torch.data.cube import build_synthetic_cube

    t_start = time.perf_counter()
    work = tmp / "dp"
    work.mkdir()
    build_synthetic_cube(work / "legacy.zarr", height=256, width=256,
                         years=tuple(range(2017, 2022)), n_cont=8, n_cat=2,
                         n_naip=3, seed=SEED)
    res = {"nccl_world1": dp_world1_clis(tmp, work / "legacy.zarr", device)}
    res["gloo_two_ranks"] = dp_two_ranks(work, device)
    res["nccl_world1"]["allreduce"] = nccl_world1_allreduce_ms(device)
    res["seconds"] = time.perf_counter() - t_start
    return res


# ---------------------------------------------------------------------------
# phase 20: the compact wire, K steps per block and the VQ-VAE config ladder
# ---------------------------------------------------------------------------
WIRE_VQ_STEPS = 8              # one epoch of each of the three CLI runs
WIRE_VQ_BLOCK = 4              # steps_per_dispatch of the third run
WIRE_LOSS_REL_BOUND = 2e-2     # tests/test_wire.py: the wire against plain
WIRE_FRL_BATCHES = 2           # phase 14's 16 train patches, batches of 12
# the config ladder's cubes, as tests/test_config_ladder.py builds them
LADDER = {"vae_evt_only.yaml": dict(n_cont=0, n_cat=2, n_naip=0),
          "vae_static_only.yaml": dict(years=(2021,), n_cont=6, n_cat=0,
                                       n_naip=3),
          "vae_full.yaml": dict(n_cont=56, n_cat=4, n_naip=4)}
LADDER_STEPS = 4


def _vq_cli(zarr: Path, run_dir: Path, config: dict, steps: int,
            device: str) -> dict:
    """``train_vqvae.main`` on a YAML holding ``config``, one epoch of
    ``steps``, with K4's count set to 0 just before and read just after.
    -> its history row, K4's launches, the validation steps it ran, the
    final parameters and its seconds."""
    import yaml

    from forest_tpu_torch.data.samplers import ChunkBatchSampler
    from forest_tpu_torch.data.vqvae_dataset import VQVAEDataset
    from forest_tpu_torch.training import train_vqvae

    cfg_path = run_dir.with_suffix(".yaml")
    cfg_path.write_text(yaml.safe_dump({"train_vqvae": config}))
    argv = ["--config", str(cfg_path), "--zarr", str(zarr), "--run-dir",
            str(run_dir), "--epochs", "1", "--steps-per-epoch", str(steps)]
    if device != "cuda":
        argv += ["--device", device]
    reset_launches()
    t0 = time.perf_counter()
    train_vqvae.main(argv)
    _sync(device)
    seconds = time.perf_counter() - t0
    launches = read_launches()["vq_core"]
    (row,) = json.loads((run_dir / "history.json").read_text())
    cfg = train_vqvae.load_config(str(cfg_path), {})
    ds_va = VQVAEDataset(zarr, run_dir / "schema.json",
                         split=cfg["split_val"],
                         block_size=tuple(cfg["block_size"]))
    val_steps = min(cfg.get("val_steps", 20), len(ChunkBatchSampler(
        ds_va.xy_by_chunk, cfg["batch_size"], drop_last=True,
        replacement_within_chunk=True)))
    return {"history": row, "launches": launches, "val_steps": val_steps,
            "params": _ckpt_params(run_dir / "ckpt" / "ckpt_last.msgpack"),
            "seconds": seconds}


def _launches_want(steps: int, device: str) -> int:
    """A kernel's launches over ``steps`` steps that launch it once each:
    on the CPU the wrappers run their plain versions and count none."""
    import torch
    return steps if torch.device(device).type == "cuda" else 0


def _metrics(row: dict) -> dict:
    return {k: v for k, v in row.items()
            if k.startswith(("train/", "val/"))}


def _same_bits(a, b) -> bool:
    """Two host arrays (or CPU tensors) equal byte for byte, NaN bits too."""
    import numpy as np
    a, b = (x.numpy() if hasattr(x, "numpy") else np.asarray(x)
            for x in (a, b))
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


def decode_card_vs_cpu(encoded: dict, device: str = "cuda") -> int:
    """``decode_wire_batch`` of one encoded batch on ``device`` and on the
    CPU, every leaf compared bit for bit. -> the leaves compared."""
    from forest_tpu_torch.data.loader import make_device_put
    from forest_tpu_torch.data.wire import decode_wire_batch

    card = decode_wire_batch(make_device_put(device, ())(encoded), device)
    cpu = decode_wire_batch(make_device_put("cpu", ())(encoded), "cpu")
    leaves = {}
    for k, v in cpu.items():
        if isinstance(v, dict):
            leaves.update({f"{k}/{n}": (card[k][n], a)
                           for n, a in v.items()})
        else:
            leaves[k] = (card[k], v)
    bad = [k for k, (c, h) in leaves.items() if not _same_bits(c.cpu(), h)]
    if bad or sorted(card) != sorted(cpu):
        raise AssertionError(f"decode on {device} differs from the CPU's: "
                             f"{bad}")
    return len(leaves)


def wire_vqvae_and_check(work: Path, device: str = "cuda") -> dict:
    """(a) the VQ-VAE of configs/vae_v0.yaml at its full width on a 256²
    legacy cube, three CLI runs of WIRE_VQ_STEPS from one seed: plain,
    ``wire_compact: true``, and the wire with ``steps_per_dispatch:
    WIRE_VQ_BLOCK``, which the CLI runs one step at a time (cuDNN
    deterministic for the three, so that the last two can be compared bit
    for bit). The wire run and the one with the block key equal in history
    and parameters; the wire within WIRE_LOSS_REL_BOUND of plain
    (train and validation loss_total); K4 once a train and a validation
    step in each. Printed: H2D bytes of one batch plain and on the wire, ms
    per step of each run. (d) the decode of that wire batch, with a uint16
    id leaf added, on the card equal to the CPU's."""
    import numpy as np
    import torch
    import yaml

    from forest_tpu_torch.data.cube import build_synthetic_cube
    from forest_tpu_torch.data.samplers import ChunkBatchSampler
    from forest_tpu_torch.data.vqvae_dataset import VQVAEDataset
    from forest_tpu_torch.data.wire import encode_wire_batch, wire_bytes
    from forest_tpu_torch.training import train_vqvae

    zarr = work / "wire_legacy.zarr"
    build_synthetic_cube(zarr, height=256, width=256,
                         years=tuple(range(2017, 2022)), n_cont=8, n_cat=2,
                         n_naip=3, seed=SEED)
    base = yaml.safe_load((ROOT / "configs/vae_v0.yaml").read_text())[
        "train_vqvae"]
    runs = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for name, extra in (("plain", {}), ("wire", {"wire_compact": True}),
                            ("block", {"wire_compact": True,
                                       "steps_per_dispatch": WIRE_VQ_BLOCK})):
            runs[name] = _vq_cli(zarr, work / f"vq_{name}",
                                 dict(base, **extra), WIRE_VQ_STEPS, device)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    wire, block, plain = runs["wire"], runs["block"], runs["plain"]
    problems = []
    if _metrics(wire["history"]) != _metrics(block["history"]):
        problems.append("the history with steps_per_dispatch differs from "
                        "the wire run's")
    differ = [n for n, v in wire["params"].items()
              if not _same_bits(v, block["params"][n])]
    if differ:
        problems.append(f"parameters with steps_per_dispatch differ: "
                        f"{differ}")
    rel = {k: _rel(wire["history"][k], plain["history"][k])
           for k in ("train/loss_total", "val/loss_total")}
    if max(rel.values()) > WIRE_LOSS_REL_BOUND:
        problems.append(f"the wire against plain: {rel}")
    for name, r in runs.items():
        if r["launches"] != _launches_want(WIRE_VQ_STEPS + r["val_steps"],
                                           device):
            problems.append(f"{name}: {WIRE_VQ_STEPS} train and "
                            f"{r['val_steps']} validation steps launched "
                            f"vq_core {r['launches']} times")
        bad = [k for k, v in _metrics(r["history"]).items()
               if not np.isfinite(v)]
        if bad:
            problems.append(f"{name}: non-finite {bad}")
    if problems:
        raise AssertionError(f"wire VQ-VAE: {problems}")

    ds = VQVAEDataset(zarr, work / "vq_plain" / "schema.json",
                      split="train", block_size=tuple(base["block_size"]))
    idx = next(iter(ChunkBatchSampler(ds.xy_by_chunk, base["batch_size"],
                                      drop_last=True, seed=SEED)))
    host = {k: v for k, v in ds.load_batch(idx).items()
            if k not in ("years", "yx")}
    enc = encode_wire_batch(host, int_bounds=train_vqvae.wire_int_bounds(ds))
    # the uint16 tier (a vocabulary of more than 256 ids), extremes included
    ids = np.random.default_rng(SEED).integers(0, 2 ** 16, (64, 5),
                                               dtype=np.int32)
    ids.reshape(-1)[:2] = (0, 2 ** 16 - 1)
    u16 = encode_wire_batch({"ids": ids}, int_bounds={"ids": 2 ** 16})
    if u16["ids"].dtype != np.uint16:
        raise AssertionError(f"ids below 2**16 travel as {u16['ids'].dtype}")
    return {
        "runs": {n: {"seconds": r["seconds"], "launches": r["launches"],
                     "val_steps": r["val_steps"],
                     "ms_per_step": 1e3 * r["history"]["step_s"]
                     / WIRE_VQ_STEPS,
                     "train_loss_total": r["history"]["train/loss_total"],
                     "val_loss_total": r["history"]["val/loss_total"]}
                 for n, r in runs.items()},
        "wire_vs_plain_rel": rel, "block_equals_wire": True,
        "bytes_per_batch": {"plain": wire_bytes(host),
                            "wire": wire_bytes(enc)},
        "decode_leaves_card_vs_cpu": decode_card_vs_cpu(dict(enc, **u16),
                                                        device)}


def wire_frl_and_check(tmp: Path, device: str = "cuda") -> dict:
    """(b) ``run_epoch`` of the v1 model over phase 14's cube and configs in
    ``tmp``, WIRE_FRL_BATCHES steps with ``wire_compact=True`` and
    ``wire_skip`` from the step's configuration, then the same epoch from
    the same seeded start with the wire off: loss_total within
    WIRE_LOSS_REL_BOUND; K1, K2 and K3 launched every step of the wire
    epoch. One batch of the train split assembled channel-major, encoded,
    copied and decoded on the card: equal to the channel-last batch rounded
    to bfloat16 bit for bit, the categorical group, the mask groups and the
    windows exact; (d) that decode equal to the CPU's. Printed: the
    loader's seconds per batch channel-major against the channel-last
    stack (two of each, in turns)."""
    import numpy as np
    import torch
    import yaml

    from forest_tpu_torch.data.loader import make_device_put
    from forest_tpu_torch.data.wire import (decode_wire_batch,
                                            encode_wire_batch, to_bfloat16,
                                            wire_bytes)
    from forest_tpu_torch.training import train_representation as tr
    from forest_tpu_torch.training.representation import loops
    from forest_tpu_torch.training.representation import step as step_mod
    from forest_tpu_torch.training.representation.training_config import (
        parse_training_config)

    cfg = parse_training_config(str(tmp / "training.yaml"))
    model_cfg = yaml.safe_load(
        (ROOT / "configs/frl_repr_model_v1.yaml").read_text())
    epochs = {}
    for wire in (True, False):
        ctx = tr.setup(cfg, str(tmp / "bindings.yaml"), model_cfg, device)
        weights = {k: torch.full((), float(v), device=device)
                   for k, v in ctx["weights"].items()}
        cur = {"input_dropout_rate": torch.full((), 0.0, device=device),
               "min_gate": torch.full((), 1.0, device=device)}
        skip = step_mod.wire_exact_groups(ctx["step_cfg"])
        reset_launches()
        _, m = loops.train_epoch(
            ctx["ds_train"], ctx["train_step"], ctx["state"],
            batch_size=cfg.epoch.batch_size, weights=weights,
            curriculum=cur, rng_seed=cfg.seed,
            num_workers=cfg.hardware.num_workers,
            max_batches=WIRE_FRL_BATCHES, device=device, wire_compact=wire,
            wire_skip=skip)
        _sync(device)
        epochs[wire] = {"metrics": m, "launches": read_launches()}
    on, off = epochs[True], epochs[False]
    n = on["metrics"]["n_steps"]
    rel = _rel(on["metrics"]["loss_total"], off["metrics"]["loss_total"])
    losses = {k: _rel(v, off["metrics"][k])
              for k, v in on["metrics"].items()
              if k.startswith("loss_") and abs(off["metrics"][k]) > 1e-6}
    problems = []
    if rel > WIRE_LOSS_REL_BOUND or not np.isfinite(rel):
        problems.append(f"loss_total {rel:.3g} from the plain epoch's")
    if n != WIRE_FRL_BATCHES or any(
            on["launches"][k] < _launches_want(n, device)
            for k in ("bank_mix_fwd", "bank_mix_bwd", "scatter_add_rows")):
        problems.append(f"{n} steps launched {on['launches']}")

    ds = ctx["ds_train"]
    idx = [i % len(ds) for i in range(cfg.epoch.batch_size)]
    load_s = {"channel_last": [], "channel_major": []}
    batches = {}
    for layout in ("channel_last", "channel_major", "channel_major",
                   "channel_last"):
        ds.set_wire_layout(layout == "channel_major")
        t0 = time.perf_counter()
        batches[layout] = ds.load_batch(idx)
        load_s[layout].append(time.perf_counter() - t0)
    ds.set_wire_layout(False)
    plain = batches["channel_last"]
    enc = encode_wire_batch(batches["channel_major"], skip=skip)
    dec = decode_wire_batch(make_device_put(device, ())(enc), device)
    inexact = []
    for k, v in plain.items():
        exact = (k in skip or "categorical" in k or k.endswith("_mask")
                 or k == "__window__")
        want = v if exact else to_bfloat16(v).float().numpy()
        if not (dec[k].is_contiguous()
                and _same_bits(dec[k].cpu(), want)):
            inexact.append(k)
    if inexact or sorted(dec) != sorted(plain):
        problems.append(f"decoded channel-major groups {inexact} differ "
                        f"from the channel-last batch")
    if problems:
        raise AssertionError(f"wire FRL epoch: {problems}")
    return {"n_steps": n, "loss_total_rel": rel, "loss_rel": losses,
            "launches": {k: on["launches"][k] for k in (
                "bank_mix_fwd", "bank_mix_bwd", "scatter_add_rows")},
            "epoch_s": {"wire": on["metrics"]["epoch_time_s"],
                        "plain": off["metrics"]["epoch_time_s"]},
            "wait_s": {"wire": on["metrics"]["wait_s"],
                       "plain": off["metrics"]["wait_s"]},
            "load_batch_s": load_s,
            "bytes_per_batch": {"plain": wire_bytes(plain),
                                "wire": wire_bytes(enc)},
            "decode_leaves_card_vs_cpu": decode_card_vs_cpu(enc, device)}


def ladder_and_check(work: Path, device: str = "cuda") -> dict:
    """(c) configs/vae_evt_only.yaml, vae_static_only.yaml and vae_full.yaml
    at their full widths, each on a 256² cube of its sources (LADDER), one
    CLI epoch of LADDER_STEPS: every metric finite, K4 once a train and a
    validation step."""
    import numpy as np
    import yaml

    from forest_tpu_torch.data.cube import build_synthetic_cube

    res = {}
    for name, cube_kw in LADDER.items():
        stem = name.split(".")[0]
        zarr = work / f"{stem}.zarr"
        build_synthetic_cube(zarr, height=256, width=256, seed=SEED,
                             **cube_kw)
        config = yaml.safe_load((ROOT / "configs" / name).read_text())[
            "train_vqvae"]
        r = _vq_cli(zarr, work / stem, config, LADDER_STEPS, device)
        bad = [k for k, v in _metrics(r["history"]).items()
               if not np.isfinite(v)]
        if bad or r["launches"] != _launches_want(
                LADDER_STEPS + r["val_steps"], device):
            raise AssertionError(
                f"{name}: non-finite {bad}; {LADDER_STEPS} train and "
                f"{r['val_steps']} validation steps launched vq_core "
                f"{r['launches']} times")
        res[stem] = {"seconds": r["seconds"], "launches": r["launches"],
                     "val_steps": r["val_steps"],
                     "train_loss_total": r["history"]["train/loss_total"],
                     "val_loss_total": r["history"]["val/loss_total"],
                     "ms_per_step": 1e3 * r["history"]["step_s"]
                     / LADDER_STEPS,
                     "widths": {k: config[k] for k in (
                         "emb_dim", "hidden", "codebook_size")}}
    return res


def wire_and_check(tmp: Path, device: str = "cuda") -> dict:
    """Phase 20 on phase 14's cube, stats and configs in ``tmp``: (a) and
    (d) wire_vqvae_and_check, (b) wire_frl_and_check, (c)
    ladder_and_check."""
    t_start = time.perf_counter()
    work = tmp / "wire"
    work.mkdir()
    res = {"vqvae": wire_vqvae_and_check(work, device),
           "frl": wire_frl_and_check(tmp, device),
           "ladder": ladder_and_check(work, device)}
    res["seconds"] = time.perf_counter() - t_start
    return res


# phase 21: the FRL step is counted on the card and on the CPU at this batch
# (the CPU runs the v1 model at 256^2 in a few seconds a sample)
FLOPS_PARITY_BATCH = 2


def flops_and_check(frl_step_ms: float, vq_step_ms: float,
                    device: str = "cuda") -> dict:
    """Phase 21: the FLOPs of one FRL train step as phase 8 builds it (B 12)
    and of one VQ-VAE train step as phase 12 builds it, by
    ``utils.flops.step_flops`` on ``device`` (each kernel by its declared
    cost), and their MFU over ``frl_step_ms`` and ``vq_step_ms`` (phase 8's
    and phase 12's medians) against the H100's dense peaks. The FRL step at
    B FLOPS_PARITY_BATCH and the VQ-VAE step are counted on ``device`` and
    on the CPU as well: the counts must agree operator by operator.
    -> the counts, their split by operator and the MFU fields."""
    import torch

    from forest_tpu_torch.data.cube import build_synthetic_cube
    from forest_tpu_torch.utils import flops as fl

    def frl(dev, bsz=None):
        t = build_train_step(dev, bsz=bsz)
        return t.train_step, (t.state, t.batch, t.gen, t.weights,
                              t.curriculum)

    def vqvae(dev, zarr, run_dir):
        k = build_vqvae_step(zarr, run_dir, dev)
        return k.train_step, (k.state, k.batch, k.weights)

    t0 = time.perf_counter()
    fn, args = frl(device)
    res = {"frl": {"batch": TRAIN_SHAPE[0],
                   "flops": fl.step_flops(fn, *args)}}
    del fn, args
    torch.cuda.empty_cache()
    parity = {}
    for dev in (device, "cpu"):
        fn, args = frl(dev, FLOPS_PARITY_BATCH)
        t1 = time.perf_counter()
        parity[dev] = {"frl": fl.flops_by_op(fn, *args),
                       "frl_s": time.perf_counter() - t1}
        del fn, args
    with tempfile.TemporaryDirectory() as d:
        zarr = Path(d) / "cube.zarr"
        build_synthetic_cube(zarr, height=256, width=256,
                             years=tuple(range(2017, 2022)), n_cont=8,
                             n_cat=2, n_naip=3, seed=SEED)
        for dev in (device, "cpu"):
            fn, args = vqvae(dev, zarr, Path(d) / "run")
            parity[dev]["vqvae"] = fl.flops_by_op(fn, *args)
            del fn, args
    res["vqvae"] = {"batch": VQ_STEP_SHAPE[0],
                    "flops": sum(parity[device]["vqvae"].values())}
    res["frl"].update(parity_batch=FLOPS_PARITY_BATCH,
                      cpu_parity_step_s=parity["cpu"]["frl_s"])
    for key, ms in (("frl", frl_step_ms), ("vqvae", vq_step_ms)):
        got, cpu = parity[device][key], parity["cpu"][key]
        if got != cpu:
            raise AssertionError(f"{key}: the step counts {got} on "
                                 f"{device} and {cpu} on the CPU")
        res[key].update(by_op=got, parity_flops=sum(got.values()),
                        step_ms=ms,
                        mfu=fl.mfu_fields(key, res[key]["flops"], ms / 1e3))
    res["reference_a40_mfu_pct"] = 100.0 * fl.mfu(
        res["frl"]["flops"], fl.REFERENCE_FRL_S_PER_BATCH,
        fl.PEAK_TFLOPS["a40_bf16"])
    res["seconds"] = time.perf_counter() - t0
    return res


def vq_paths(vqvae_training: int = 0, kernel_check: int = 0,
             variant_sweep: int = 0) -> dict:
    """Launches of a VQ kernel by path: the VQ-VAE's CLI run, the op called
    directly at the bench shape (the timed runs of its kernel phase: the two
    assignment ops have no other caller than a user), the variant sweep."""
    return {"vqvae_training": vqvae_training, "kernel_check": kernel_check,
            "variant_sweep": variant_sweep}


def kernel_entry(name: str, check: dict, launches: dict, **extra) -> dict:
    source, replaces = KERNELS[name]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(launches.values()),
            "launches_by_path": launches,
            "max_abs_err": check["max_abs_err"], "ms": check["ms"],
            "plain_ms": check["plain_ms"], "bound_ms": check["bound_ms"],
            "bound_by": check["bound_by"],
            "library_ms": check.get("library_ms"),
            "shape": check["shape"], "dtype": check["dtype"], **extra}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    missing = sorted({src for src, _ in KERNELS.values()
                      if not (ROOT / src).is_file()}
                     | ({FIXTURE} if not (ROOT / FIXTURE).is_dir()
                        else set()))
    if missing:
        print(f"chip_smoke: {missing} not beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import forest_tpu_torch
    if Path(forest_tpu_torch.__file__).resolve().parent != \
            ROOT / "forest_tpu_torch":
        print("chip_smoke: forest_tpu_torch resolves outside this checkout",
              file=sys.stderr)
        return 1
    from forest_tpu_torch.ops import _cuda_build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if sys.argv[1:2] == ["--dp-rank"]:         # one of phase 19's ranks
        rank, world, port = (int(a) for a in sys.argv[2:5])
        return dp_rank_main(rank, world, port, Path(sys.argv[5]),
                            sys.argv[6])
    t_start = time.perf_counter()

    card = card_line()                                        # phase 1
    log(card)

    t0 = time.perf_counter()                                  # phase 2
    _cuda_build.load_libraries(list(LIBRARIES))
    log(f"built {', '.join(LIBRARIES)} in {time.perf_counter() - t0:.2f} s")
    for name in LIBRARIES:
        log(f"{name}: {_cuda_build.build_info[name]['seconds']:.2f} s")
        log(_cuda_build.build_info[name]["log"].strip())

    if sys.argv[1:] == ["--profile-training"]:
        profile_training()
        return 0
    if sys.argv[1:] == ["--profile-training-type-only"]:
        profile_training(type_only=True)
        return 0
    if sys.argv[1:] == ["--profile-vqvae"]:
        profile_vqvae()
        return 0
    if sys.argv[1:] == ["--profile-vq-core"]:
        vq_core_split(torch.Generator(device="cuda").manual_seed(SEED))
        return 0
    if sys.argv[1:] == ["--profile-vq-assign"]:
        profile_vq_assign(torch.Generator(device="cuda").manual_seed(SEED))
        return 0
    if sys.argv[1:]:
        print(f"chip_smoke: unknown arguments {sys.argv[1:]}",
              file=sys.stderr)
        return 2

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    f32 = check_fwd(SERVE_SHAPE, torch.float32, gen, timed=True)  # phase 3
    bf16 = check_fwd(SERVE_SHAPE, torch.bfloat16, gen, timed=True)
    for shape in (ODD_SHAPE,) + FWD_BORDER_SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            check_fwd(shape, dt, gen, timed=False)
    fwd_train = check_fwd(TRAIN_SHAPE, torch.bfloat16, gen, timed=True)

    bwd_f32 = check_bwd(TRAIN_SHAPE, torch.float32, gen, timed=True)  # 4
    bwd_bf16 = check_bwd(TRAIN_SHAPE, torch.bfloat16, gen, timed=True)
    for shape in (ODD_SHAPE,) + BWD_BORDER_SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            check_bwd(shape, dt, gen, timed=False)
    torch.cuda.empty_cache()

    scat = check_scatter(SCATTER_SHAPE, gen, timed=True)      # phase 5
    check_scatter(SCATTER_ODD_SHAPE, gen, timed=False)
    check_scatter_exact(gen)

    with tempfile.TemporaryDirectory() as d:                  # phase 6
        ckpt, bpath = write_checkpoint(Path(d))
        patches = make_patches(SERVE_SHAPE[0], SERVE_SHAPE[1])
        serve = serve_and_check(ckpt, bpath, patches)         # phase 7
        checked = serve.pop("checked")
        plain = check_against_plain(ckpt, bpath, patches[1], checked)
    log(f"serving: {json.dumps(serve)}")
    del patches, checked
    torch.cuda.empty_cache()

    train = train_and_check()                                 # phase 8
    log(f"training: {json.dumps(train)}")
    torch.cuda.empty_cache()
    evt_diag = evt_diag_step_check()

    core = check_vq_core(gen)                                 # phase 9
    assign = check_vq_assign(gen)                             # phase 10
    variants = check_variants(gen)                            # phase 11
    torch.cuda.empty_cache()
    vqvae = vqvae_train_and_check()                           # phase 12
    log(f"vqvae training: {json.dumps(vqvae)}")
    fixture = check_fixture()                                 # phase 13
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as d:
        cli = cli_train_and_check(Path(d))                    # phase 14
        log(f"training CLI: {json.dumps(cli)}")
        torch.cuda.empty_cache()
        evals = eval_tools_and_check(Path(d))                 # phase 15
        log(f"eval tools: {json.dumps(evals)}")
        torch.cuda.empty_cache()
        clus = clustering_tools_and_check(Path(d))            # phase 16
        log(f"clustering tools: {json.dumps(clus, default=float)}")
        torch.cuda.empty_cache()
        diag = diagnostics_tools_and_check(Path(d))           # phase 17
        log(f"diagnostics tools: {json.dumps(diag, default=float)}")
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as d18:
            cube = cube_building_and_check(Path(d18))         # phase 18
        log(f"cube building: {json.dumps(cube, default=float)}")
        torch.cuda.empty_cache()
        dpar = data_parallel_and_check(Path(d))               # phase 19
        log(f"data parallel: {json.dumps(dpar, default=float)}")
        torch.cuda.empty_cache()
        wire = wire_and_check(Path(d))                        # phase 20
    log(f"wire, blocks and ladder: {json.dumps(wire, default=float)}")
    torch.cuda.empty_cache()
    flops = flops_and_check(train["step_ms_median"],          # phase 21
                            vqvae["step_ms_median"])
    log(f"step FLOPs: {json.dumps(flops)}")

    log(f"K1 f32 at {list(SERVE_SHAPE)}: {f32['ms']:.4f} ms, plain "
        f"{f32['plain_ms']:.4f} ms, bf16 {bf16['ms']:.4f} ms; at "
        f"{list(TRAIN_SHAPE)} bf16 {fwd_train['ms']:.4f} ms; K2 f32 at "
        f"{list(TRAIN_SHAPE)}: "
        f"{bwd_f32['ms']:.4f} ms, plain {bwd_f32['plain_ms']:.4f} ms ({card})")
    log(f"K2 bf16 at {list(TRAIN_SHAPE)}: {bwd_bf16['ms']:.4f} ms; K3 at "
        f"{list(SCATTER_SHAPE)}: {scat['ms']:.4f} ms as the training step "
        f"runs it, {scat['checked_ms']:.4f} ms with the host's check of the "
        f"indices, one index_add_ {scat['library_ms']:.4f} ms; back to back "
        f"{scat['back_to_back_ms']:.4f} against "
        f"{scat['library_back_to_back_ms']:.4f} ms ({card})")
    log(f"full FRL train step {train['step_ms_median']:.1f} ms median of "
        f"{TRAIN_STEPS_TIMED} (min {train['step_ms_min']:.1f}, max "
        f"{train['step_ms_max']:.1f}), peak {train['peak_memory_gb']:.2f} "
        f"GB; EVT + diag step loss_evt {evt_diag['loss_evt']:.4g} ({card})")
    log(f"K4 vq_core at {list(VQ_SHAPE)}: {core['ms']:.4f} ms, plain "
        f"{core['plain_ms']:.4f} ms; at {list(VQ_STEP_SHAPE)} "
        f"{core['step_shape_device_ms']:.4f} ms on the device in "
        f"{core['launches_per_call']['x'.join(map(str, VQ_STEP_SHAPE))]:.0f} "
        f"launch(es), {core['step_shape_host_ms']:.4f} ms from call to "
        f"return; K5 vq_assign f32 "
        f"{assign['f32']['ms']:.4f} ms, bf16 operands "
        f"{assign['bf16']['ms']:.4f} ms; K6 row-major "
        f"{variants['vq_variant_rows']['ms']:.4f} ms, K7 transposed "
        f"{variants['vq_variant_cols']['ms']:.4f} ms ({card})")
    log(f"K5 vq_assign against addmm + argmin: f32 "
        f"{assign['f32']['ms']:.4f} / {assign['f32']['library_ms']:.4f} ms, "
        f"bf16 operands {assign['bf16']['ms']:.4f} / "
        f"{assign['bf16']['library_ms']:.4f} ms; K7 f32 by tile "
        + ", ".join(f"{t_}: {ms:.4f}" for t_, ms in
                    variants["vq_variant_cols"]["ms_by_tile"].items())
        + " ms, bf16-mxu by tile "
        + ", ".join(f"{t_}: {ms:.4f}" for t_, ms in
                    variants["vq_variant_cols"]["bf16_mxu_ms_by_tile"]
                    .items())
        + f" ms, K6 {variants['vq_variant_rows']['ms']:.4f} ms, bf16-mxu "
        f"{variants['vq_variant_rows']['bf16_mxu_ms']:.4f} ms, bf16-io "
        f"{variants['vq_variant_rows']['bf16_io_ms']:.4f} ms ({card})")
    log(f"fixture: {fixture['chunks_compared']} chunks, "
        f"{fixture['native_decoded_chunks']} decoded natively, "
        f"{fixture['patches']} patches, libblosc loads: "
        f"{fixture['libblosc_loads']}, new arrays: "
        f"{fixture['default_compressor']} ({card})")
    log(f"vqvae train step {vqvae['step_ms_median']:.2f} ms median of 50 on "
        f"a resident batch of 64, {vqvae['step_ms_in_cli_mean'][-1]:.2f} ms "
        f"mean inside the CLI's last epoch ({card})")
    for e in cli["epochs"]:
        log(f"training CLI epoch {e['epoch']}: {e['n_steps']} steps, "
            f"{e['ms_per_step']:.1f} ms per step, loader wait "
            f"{100 * e['wait_share']:.1f} % of the epoch's "
            f"{e['epoch_time_s']:.2f} s (validation "
            f"{e['val_epoch_time_s']:.2f} s), train/loss_total "
            f"{e['train_loss_total']:.4f}, val/loss_total "
            f"{e['val_loss_total']:.4f}"
            + (" (under torch.profiler)" if e["profiled"] else "")
            + f" ({card})")
    log(f"training CLI: cube of {CLI_CUBE_HW}^2 built in "
        f"{cli['cube_s']:.2f} s, stats in {cli['stats_s']:.2f} s; host "
        f"syncs per step (profiled epoch): "
        + ", ".join(f"{k} {v:.1f}" for k, v in cli["syncs_per_step"].items())
        + f"; peak {cli['peak_memory_gb']:.2f} GB; K1/K2/K3 launches "
        f"{cli['launches']} in {cli['train_steps']} train and "
        f"{cli['val_steps']} val steps ({card})")
    one = cli["one_batch"]
    log(f"training CLI, one batch of {TRAIN_SHAPE[0]}: decoded on the host "
        f"in {one['load_batch_s']:.3f} s, {one['batch_mb']:.1f} MB pinned "
        f"and copied to the card in {one['device_put_s']:.3f} s, the CLI's "
        f"step on it resident {one['resident_step_ms']:.1f} ms (median of 3, "
        f"diagnostics on) ({card})")
    ex = evals["export"]
    log(f"eval tools on the {CLI_CUBE_HW}^2 cube: export_embeddings --phase "
        f"{ex['seconds']:.2f} s for {ex['patches']} patches of 256 "
        f"({ex['patches_per_s']:.2f} patches/s, {ex['mb_written']:.1f} MB "
        f"written, K1 {ex['k1_launches']} launches in {ex['batches']} "
        f"batches); one batch of 4: decoded in "
        f"{ex['one_batch']['load_batch_s']:.3f} s, copied in "
        f"{ex['one_batch']['device_put_s']:.3f} s, type + dense phase "
        f"{ex['one_batch']['device_ms']:.1f} ms on the card, float16 back "
        f"in {ex['one_batch']['d2h_s']:.3f} s, "
        f"{ex['one_batch']['float16_mb']:.1f} MB written "
        f"({ex['one_batch']['compressor']}) in "
        f"{ex['one_batch']['write_s']:.3f} s; embed_locations "
        f"{evals['embed']['seconds']:.2f} s for "
        f"{evals['embed']['points']} points (K1 "
        f"{evals['embed']['k1_launches']}); train_probe "
        f"{evals['train_probe']['seconds']:.2f} s for {EVAL_PROBE_EPOCHS} "
        f"epochs (K1 {evals['train_probe']['k1_launches']}); phase_probe "
        f"{evals['phase_probe']['seconds']:.2f} s (K1 "
        f"{evals['phase_probe']['k1_launches']}) ({card})")
    g_, l_, f_ = clus["gmm"], clus["landscape"], clus["fia"]
    tf = l_["timed_fit"]
    log(f"clustering tools on the {CLI_CUBE_HW}^2 cube: gmm "
        f"{g_['seconds']:.2f} s ({g_['pixels_fit']} pixels fit, best K "
        f"{g_['best_k']}, K1 {g_['k1_launches']} launches in "
        f"{g_['batches']} batches, K1 at {g_['k1_vs_plain']['k1_input']} "
        f"{g_['k1_vs_plain']['rel_err_vs_plain']:.3g} from its plain "
        f"version); "
        f"landscape_categories {l_['seconds']:.2f} s ({l_['pixels_fit']} "
        f"of {l_['pixels_seen']} pixels fit, K_type {l_['k_type']}, "
        f"{l_['dynamic_clusters']} dynamic, K_phase {l_['k_phase']}, "
        f"{l_['passes']} passes, K1 {l_['k1_launches']} launches); one "
        f"diag GMM fit at K {tf['k']} on "
        f"{tf['rows'][0]} x {tf['rows'][1]}: {tf['n_iter']} EM iterations "
        f"in {tf['seconds']:.2f} s ({tf['ms_per_iter']:.2f} ms each); fia: "
        f"embed_locations {f_['embed_seconds']:.2f} s for {f_['points']} "
        f"points (K1 {f_['k1_launches']}), "
        + ", ".join(f"{k} {f_[k]['seconds']:.2f} s" for k in
                    ("hierarchical", "hdbscan", "removals", "probe_table"))
        + "; card against the CPU (s): "
        + ", ".join(f"{k} {v['card_s']:.3f} / {v['cpu_s']:.3f}"
                    for k, v in clus["card_vs_cpu"].items())
        + f" ({card})")
    v_, pd_, ri_, hd_ = (diag[k] for k in ("visualize", "phase_diagnostics",
                                           "reference_import", "hdbscan"))
    log(f"diagnostics tools on the {CLI_CUBE_HW}^2 cube in "
        f"{diag['seconds']:.2f} s: visualize --probe --forest-diag "
        f"{v_['seconds']:.2f} s ({v_['figures']} figures, "
        f"{v_['figures_skipped']} skipped, K1 {v_['k1_launches']} "
        f"launches; gate forward "
        f"{v_['card_vs_cpu']['k1_vs_plain']['gate_rel_err_vs_plain']:.3g} "
        f"from its plain version; forest-diag records card "
        f"{v_['card_vs_cpu']['card_s']:.2f} s, CPU "
        f"{v_['card_vs_cpu']['cpu_s']:.2f} s); phase_diagnostics --probe "
        f"{pd_['seconds']:.2f} s (CPU {pd_['cpu_seconds']:.2f} s, K1 "
        f"{pd_['k1_launches']} launches, {pd_['n_evt_classes']} EVT "
        f"classes, {pd_['n_pixels_total']} pixels, tables within "
        f"{max(pd_['tables_vs_cpu'].values()):.3g} of the CPU's); "
        f"reference import {ri_['import_s']:.2f} s (z_type "
        f"{ri_['z_type_rel_err_vs_plain']:.3g} from its plain version); "
        f"HDBSCAN at N {hd_['n']}, D {hd_['d']}: {hd_['seconds']:.2f} s, "
        f"peak {hd_['peak_bytes'] / 2 ** 20:.1f} MiB against "
        f"{hd_['dense_bytes'] / 1e9:.1f} GB dense, {hd_['clusters']} "
        f"clusters ({card})")
    cb, ccpu = cube["build"]["card"], cube["build"]["cpu"]
    log(f"cube building at {CUBE_HW}^2 x {CUBE_YEARS[1] - CUBE_YEARS[0] + 1}"
        f" years in {cube['seconds']:.2f} s (sources written in "
        f"{cube['sources_s']:.2f} s): build_zarr_v2 on the card "
        f"{cb['seconds']:.2f} s (decode {cb['decode']:.2f}, device "
        f"{cb['device']:.2f} of which reprojection {cb['reproject']:.3f} and "
        f"statistics {cb['stats']:.3f}, zarr write {cb['write']:.2f} s of "
        f"{cb['write_mb']:.1f} MB raw at {cb['write_mb_per_s']:.1f} MB/s), "
        f"on the CPU {ccpu['seconds']:.2f} "
        f"s (decode {ccpu['decode']:.2f}, passes {ccpu['device']:.2f} of "
        f"which reprojection {ccpu['reproject']:.3f} and statistics "
        f"{ccpu['stats']:.3f}, write {ccpu['write']:.2f} s at "
        f"{ccpu['write_mb_per_s']:.1f} MB/s raw); the card's cube equal to "
        f"the CPU's ({cube['card_vs_cpu']['arrays']} arrays, "
        f"{cube['card_vs_cpu']['equal_bytes_mb']:.1f} MB byte for byte, the "
        f"reprojected band {cube['reprojection']['rel_err_vs_cpu']:.3g} of "
        f"its scale, {cube['reprojection']['stored_differ']} stored values "
        f"apart; bilinear alone {cube['reprojection']['card_s']:.3f} s on "
        f"the card, {cube['reprojection']['cpu_s']:.3f} s on the CPU); "
        f"zarr_info {cube['zarr_info']['seconds']:.2f} s (CPU "
        f"{cube['zarr_info']['cpu_seconds']:.2f}), zarr_builder at "
        f"{CUBE_SMALL_HW}^2 {cube['zarr_builder']['seconds']:.2f} s (CPU "
        f"{cube['zarr_builder']['cpu_seconds']:.2f}), manifest_stack "
        f"{cube['manifest_stack']['seconds']:.2f} s (CPU "
        f"{cube['manifest_stack']['cpu_seconds']:.2f}); K1 on "
        f"{cube['k1']['batch']} patches of the cube "
        f"{cube['k1']['rel_err_vs_plain']:.3g} from its plain version "
        f"({cube['k1']['launches']} launches) ({card})")
    log("codec decode by layout: " + ", ".join(
        f"{k} {v['mb_per_s']:.1f} MB/s ({v['files']} files, {v['mb']:.1f} "
        f"MB)" for k, v in sorted(cube["decode"].items())) + f" ({card})")
    log("PIL on this machine: " + (
        f"imports; its decode of all {cube['pil']['pages']} source pages "
        "equals the port's" if cube["pil"]["imports"] else
        f"does not import ({cube['pil']['why']}); the port never uses it"))
    w1, g2 = dpar["nccl_world1"], dpar["gloo_two_ranks"]
    log(f"data parallel in {dpar['seconds']:.2f} s: (a) torchrun at NCCL "
        f"world 1, FRL CLI {w1['frl']['seconds']:.2f} s (its plain run "
        f"{w1['frl']['plain_seconds']:.2f} s, the four runs at once; history "
        f"{w1['frl']['history_rel_err']}, parameters "
        f"{w1['frl']['params_rel_err']:.3g} from the plain run's), VQ-VAE "
        f"CLI {w1['vq']['seconds']:.2f} s (plain "
        f"{w1['vq']['plain_seconds']:.2f} s; parameters "
        f"{w1['vq']['params_rel_err']:.3g}); (b) two gloo ranks on one "
        f"card, FRL step ms by rank {g2['frl']['rank_step_ms']} against "
        f"the plain step on 6 rows alone {g2['frl']['plain_step_ms']:.1f} "
        f"ms, VQ-VAE step ms by rank {g2['vq']['rank_step_ms']}; the "
        f"ranks bit-identical, against the serial emulation: FRL loss "
        f"{g2['frl']['loss_rel_err']:.3g}, grad norm "
        f"{g2['frl']['grad_norm_rel_err']:.3g}, parameters "
        f"{g2['frl']['params_rel_err']:.3g}; VQ-VAE loss "
        f"{g2['vq']['loss_rel_err']:.3g}, parameters "
        f"{g2['vq']['params_rel_err']:.3g}, code indices equal; (c) "
        f"launches on the ranks {g2['launches']} ({card})")
    log(f"gradient all-reduce of the v1 model "
        f"({g2['frl']['allreduce_mb']:.2f} MB, one buffer): gloo with two "
        f"ranks on one card {g2['frl']['gloo_allreduce_ms']:.3f} ms, NCCL "
        f"world 1 {w1['allreduce']['ms']:.3f} ms ({card})")
    wv, wf, wl = wire["vqvae"], wire["frl"], wire["ladder"]
    log(f"compact wire in {wire['seconds']:.2f} s: VQ-VAE "
        f"(configs/vae_v0.yaml, batch 64) H2D bytes per batch plain "
        f"{wv['bytes_per_batch']['plain']}, wire "
        f"{wv['bytes_per_batch']['wire']}; ms per step in the CLI plain "
        f"{wv['runs']['plain']['ms_per_step']:.2f}, wire "
        f"{wv['runs']['wire']['ms_per_step']:.2f}, wire with "
        f"steps_per_dispatch {WIRE_VQ_BLOCK} (run one step at a time) "
        f"{wv['runs']['block']['ms_per_step']:.2f}, equal to the wire run "
        f"bit for bit; the wire "
        f"{max(wv['wire_vs_plain_rel'].values()):.3g} from plain; FRL v1 "
        f"epoch of {wf['n_steps']} steps with the wire "
        f"{wf['epoch_s']['wire']:.2f} s against "
        f"{wf['epoch_s']['plain']:.2f} s plain (loader wait "
        f"{wf['wait_s']['wire']:.2f} / {wf['wait_s']['plain']:.2f} s), "
        f"loss_total {wf['loss_total_rel']:.3g} from plain, H2D bytes per "
        f"batch {wf['bytes_per_batch']['plain']} plain, "
        f"{wf['bytes_per_batch']['wire']} wire; the loader's s per batch "
        f"of {TRAIN_SHAPE[0]}: channel-major "
        + ", ".join(f"{x:.3f}" for x in wf["load_batch_s"]["channel_major"])
        + ", channel-last stack "
        + ", ".join(f"{x:.3f}" for x in wf["load_batch_s"]["channel_last"])
        + f"; decode on the card equal to the CPU's on "
        f"{wv['decode_leaves_card_vs_cpu']} + "
        f"{wf['decode_leaves_card_vs_cpu']} leaves ({card})")
    log("VQ-VAE ladder at full widths, " + "; ".join(
        f"{k} {v['widths']}: {v['seconds']:.2f} s, "
        f"{v['ms_per_step']:.2f} ms per step, train/loss_total "
        f"{v['train_loss_total']:.4f}, K4 {v['launches']}"
        for k, v in wl.items()) + f" ({card})")
    ff, fv = flops["frl"], flops["vqvae"]
    log(f"FRL train step at B {ff['batch']}: {ff['flops'] / 1e9:.3f} GFLOP "
        f"(utils.flops.step_flops), {ff['step_ms']:.2f} ms (phase 8's "
        f"median): {json.dumps(ff['mfu'])}; the reference's 1.1 s a batch "
        f"on its A40 would be {flops['reference_a40_mfu_pct']:.3f} % of "
        f"149.7 TFLOP/s; VQ-VAE train step at batch {fv['batch']}: "
        f"{fv['flops'] / 1e9:.4f} GFLOP, {fv['step_ms']:.3f} ms (phase 12's "
        f"median): {json.dumps(fv['mfu'])}; the card's and the CPU's counts "
        f"equal: FRL at B {ff['parity_batch']} {ff['parity_flops']}, "
        f"VQ-VAE {fv['parity_flops']} FLOPs ({card})")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    steps = train["launches"]
    kernels = [
        kernel_entry("bank_mix_fwd", bf16,
                     {"serving": serve["launches"],
                      "training": steps["bank_mix_fwd"],
                      "training_cli": cli["launches"]["bank_mix_fwd"],
                      "eval": sum(evals[k]["k1_launches"] for k in evals),
                      "clustering": sum(clus[k]["k1_launches"] for k in
                                        ("gmm", "landscape", "fia")),
                      "diagnostics": sum(diag[k]["k1_launches"] for k in
                                         ("visualize",
                                          "phase_diagnostics")),
                      "cube_building": cube["k1"]["launches"],
                      "data_parallel": g2["launches"]["bank_mix_fwd"],
                      "wire_frl": wf["launches"]["bank_mix_fwd"]},
                     f32_ms=f32["ms"], f32_plain_ms=f32["plain_ms"],
                     f32_bound_ms=f32["bound_ms"],
                     train_shape_ms=fwd_train["ms"],
                     train_shape_plain_ms=fwd_train["plain_ms"],
                     train_shape_bound_ms=fwd_train["bound_ms"],
                     train_shape_max_abs_err=fwd_train["max_abs_err"],
                     serve_rel_err_vs_plain=plain["z_type"][
                         "rel_err_vs_plain"]),
        kernel_entry("bank_mix_bwd", bwd_bf16,
                     {"serving": 0, "training": steps["bank_mix_bwd"],
                      "training_cli": cli["launches"]["bank_mix_bwd"],
                      "data_parallel": g2["launches"]["bank_mix_bwd"],
                      "wire_frl": wf["launches"]["bank_mix_bwd"]},
                     f32_ms=bwd_f32["ms"], f32_plain_ms=bwd_f32["plain_ms"],
                     f32_bound_ms=bwd_f32["bound_ms"],
                     f32_max_abs_err=bwd_f32["max_abs_err"]),
        kernel_entry("scatter_add_rows", scat,
                     {"serving": 0, "training": steps["scatter_add_rows"],
                      "training_cli": cli["launches"]["scatter_add_rows"],
                      "data_parallel": g2["launches"]["scatter_add_rows"],
                      "wire_frl": wf["launches"]["scatter_add_rows"]},
                     checked_ms=scat["checked_ms"],
                     back_to_back_ms=scat["back_to_back_ms"],
                     library_back_to_back_ms=scat[
                         "library_back_to_back_ms"]),
        kernel_entry("vq_core", core, dict(vq_paths(
            vqvae_training=vqvae["launches"],
            kernel_check=core["path_launches"]),
            data_parallel=g2["launches"]["vq_core"],
            wire_vqvae=sum(r["launches"] for r in wv["runs"].values()),
            ladder=sum(r["launches"] for r in wl.values())),
            with_qx_ms=core["with_qx_ms"], library_is=core["library_is"],
            idx_mismatch_rows=core["idx_mismatch_rows"],
            idx_mismatch_rows_vs_cpu=core["idx_mismatch_rows_vs_cpu"],
            idx_equals_vq_assign=core["idx_equals_vq_assign"],
            step_shape_ms=vqvae["vq_core_ms_at_step_shape"],
            step_shape_device_ms=core["step_shape_device_ms"],
            step_shape_host_ms=core["step_shape_host_ms"],
            launches_per_call=core["launches_per_call"],
            split=core["split"]),
        kernel_entry("vq_assign", assign["f32"], vq_paths(
            kernel_check=assign["f32"]["path_launches"]
            + assign["bf16"]["path_launches"]),
            library_is=assign["f32"]["library_is"],
            bf16_operands_ms=assign["bf16"]["ms"],
            bf16_operands_plain_ms=assign["bf16"]["plain_ms"],
            bf16_operands_bound_ms=assign["bf16"]["bound_ms"],
            bf16_operands_bound_by=assign["bf16"]["bound_by"],
            bf16_operands_library_ms=assign["bf16"]["library_ms"],
            paths={"f32": assign["f32"]["paths"],
                   "bf16_operands": assign["bf16"]["paths"]}),
        kernel_entry("vq_variant_rows", variants["vq_variant_rows"],
                     vq_paths(variant_sweep=variants["vq_variant_rows"][
                         "path_launches"]),
                     library_is=variants["vq_variant_rows"]["library_is"],
                     bf16_mxu_ms=variants["vq_variant_rows"]["bf16_mxu_ms"],
                     bf16_io_ms=variants["vq_variant_rows"]["bf16_io_ms"],
                     tiles=variants["vq_variant_rows"]["tiles"],
                     sweep_us=variants["vq_variant_rows"]["sweep_us"]),
        kernel_entry("vq_variant_cols", variants["vq_variant_cols"],
                     vq_paths(variant_sweep=variants["vq_variant_cols"][
                         "path_launches"]),
                     library_is=variants["vq_variant_cols"]["library_is"],
                     ms_by_tile=variants["vq_variant_cols"]["ms_by_tile"],
                     bf16_mxu_ms_by_tile=variants["vq_variant_cols"][
                         "bf16_mxu_ms_by_tile"],
                     tiles=variants["vq_variant_cols"]["tiles"]),
    ]
    idle = [k["name"] for k in kernels if k["launches"] <= 0]
    idle += [f"{k['name']} on {path}" for k in kernels[:3]
             for path, n in k["launches_by_path"].items()
             if path != "serving" and n <= 0]
    idle += [f"vq_core on {path}" for path in
             ("data_parallel", "wire_vqvae", "ladder")
             if kernels[3]["launches_by_path"][path] <= 0]
    if idle or [k["name"] for k in kernels] != list(KERNELS):
        raise AssertionError(f"kernels never launched on their path: {idle}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
