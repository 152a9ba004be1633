#!/usr/bin/env python3
"""Drive the port's main path on one CUDA card and check it.

    python3 chip_smoke.py          # from the repository root

Builds the Hopper kernels of ``src/repro_torch/kernels/csrc`` with nvcc
into ``build/``, then runs:

1. kernel parity — each kernel against its plain PyTorch version on the
   card (``fft4step`` at N in {16, 64, 256, 1024, 4096} x sign +-1 within
   3e-4 * max|ref|, then ``fft4step_axis`` on axes -1, -2 and -3 of the
   1024^3 volume, each timed beside ``torch.fft.fft(x, dim=axis)`` and its
   bytes bound; (1d) ``dft_rows``, the default plan's contiguous axis,
   at (2^20, 1024) with sign +-1 and on a K-chunk's rows 2048 apart,
   within 1e-5 * max|ref| of its plain version and of ``torch.fft.fft``,
   then a ``Croft3D`` 1024^3 round trip with ``FFTOptions()`` launching
   it twice; ``rotate_blocks`` at the five ring shapes of phase 3,
   every pack and unpack bitwise, the rotation and the pack timed beside
   ``torch.roll``; then at croft-1024's 2 GiB rank blocks, every pack and
   unpack of the pencil 2x2 and slab 4 ring stages, bitwise and timed
   beside ``torch.roll``; the Hermitian unpack/extend at the 1024^3
   packed spectrum and n in {16, 64, 256} within 1e-6 * max|ref|; the
   spectral scale, full-shape at the 1024^3 r2c spectrum and broadcast
   at (2^20, 1024) with alpha in {1, 0.25}, bitwise; the Poisson multiply
   at that spectrum, bitwise), each timed with
   CUDA events beside its plain version, one library call computing the
   same function where there is one, and its bound.  A kernel whose
   bound is under 1 ms is timed by one event pair around a run of
   back-to-back launches (``time_batched_ms``), taking three copies of a
   32 MiB input in turn so none is found in the L2; 1h prints every
   wrapper's host microseconds per launch;
1c. the flash-attention kernel against its plain version: the
   reference test's four configurations and its bf16 case
   (``tests/test_kernels_fft.py:84-115``), ragged lengths (Sq = Skv =
   6145 at head_dim 120 and window 4096, Sq != Skv, rows with no valid
   key), phase 15b's microbatch (1 x 1024, 32 heads over 8, head_dim
   120, window 4096, bf16), each element within 5e-5 (f32) or 2**-6 of
   its value plus 5e-5 (bf16); then the h2o-danube-3-4b prefill shape
   (B 2, S 6144, 32 heads over 8, head_dim 120, window 4096, bf16),
   held the same way and timed beside its plain version and one
   ``scaled_dot_product_attention`` call with the causal-window mask, and
   each variant's time and launches there (the bf16 tensor-core kernel;
   the FFMA kernel in float32); then mixtral-8x22b's prefill and
   teacher-forcing shapes (B 2, S 6144 and 6145, 48 heads over 8,
   head_dim 128, window 4096, bf16), held the same way, on the
   tensor-core kernel; then whisper-base's encoder shape (B 8, Sq = Skv =
   1500, 8 heads over 8, head_dim 64, non-causal), bf16 on the
   tensor-core kernel and float32, held the same way and timed beside
   one ``scaled_dot_product_attention`` call and the operations bound;
2. the main path on one rank at full size: ``Croft3D`` forward and
   inverse of the croft-1024 grid (1024^3 complex64, an 8 GiB field)
   with ``local_impl="pallas"``, checked against ``torch.fft.fftn``
   (5e-4 * max|ref|) and by its round trip (< 1e-4); a profiled forward
   prints its device busy time and copy launches (none may be left: the
   kernel reads every axis where it lies);
2b. the spectral-solver path at full size: the croft-1024 grid as a
   real field (1024^3 float32) through the packed r2c ``Croft3D``,
   forward (against ``torch.fft.rfftn``, 5e-5 * max|ref|) and inverse
   (round trip < 1e-4), ``poisson_solve`` (against
   ``irfftn(rfftn(f) / -k^2)``; ``spectral_scale_poisson``) and a z-derivative of its solution
   through ``spectral_scale_op``; a profiled r2c forward (busy time,
   copy launches); then a c2c ``forward_filtered`` at 512^3;
3. the distributed executor: 4 ranks on the one card, joined by a gloo
   process group, pencil 2x2 and slab 4 at 256^3, every transpose impl x
   K in {1, 2} x overlap mode x output layout, each rank's block checked
   against its slice of ``torch.fft.fftn``, the impls bitwise equal; then
   one profiled pencil ring forward per K (outside the count): rank 0's
   ``rotate_blocks`` device time and any copy before the pack; then (3g)
   the gradients of ``sum |y|^2`` on the pencil mesh, c2c and packed r2c
   x batch 1 and 2 x every transpose impl, every rank calling
   ``backward()``, held against the oracle (Parseval ``2 N x``;
   ``torch.fft.rfftn`` autograd) within 1e-4 and ring/pairwise against
   alltoall within 1e-4, ``rotate_blocks`` launched in every ring and
   pairwise backward;
3b. the same ranks on a 256^3 real field: packed r2c forward, inverse
   and ``forward_filtered`` (filter after and folded before the plane
   unfold), pencil and slab x transpose impl x K, each rank's block
   against its slice of ``torch.fft.rfftn`` (1e-5 relative), bitwise
   equal across impls and K;
3c. 8 ranks on the one card (gloo), a 2x2x2 mesh at 256^3: the cell
   decomposition and pencil over the folded axis ``(("a", "b"), "c")``
   (both layouts), K in {1, 2}, against ``torch.fft.fftn``'s slice
   (5e-4 * max|ref|) and by their round trips (< 1e-4); the r2c embed
   strategy on pencil 2x4 and cell against ``torch.fft.rfftn`` (5e-5 *
   max|ref|); one cell gradient (Parseval, 1e-3);
4. h2o-danube-3-4b serving at full width and depth (24 layers, bf16,
   weights drawn on the card from the seed): ``make_serve_steps``
   prefill of a 2 x 6144 ``synth_tokens`` prompt (past the 4096-token
   window: the ring cache keeps the trailing window) and 32 greedy
   tokens; 24 ``flash_attention`` launches in the prefill, all on the
   bf16 tensor-core variant, and none in the decode, finite logits; the first decode step's logits within
   5e-2 * max|ref| of the 24-layer bf16 train pass over the prompt and
   its first token; then a float32 teacher-forcing check at full width
   and 2 layers (the FFMA variant): the decode logits at position 6144
   within 2e-4 * max|ref| of the train pass over 6145 tokens;
5. gradients at full width, meshless, croft-1024 with
   ``local_impl="pallas"``: ``loss = sum |y|^2`` of the c2c forward of a
   1024^3 complex64 field (x.grad against Parseval's 2 N x, 1e-3 of
   max|ref|; three ``fft4step`` launches each way) and of the packed
   r2c ``forward_filtered`` of a 1024^3 real field by a full complex
   filter (h.grad against 2 |s|^2 h and x.grad against
   ``torch.fft.rfftn`` autograd, 1e-4 of max|ref|; the unpack in the
   forward, ``spectral_scale_full`` twice and ``fft4step`` three times
   in the backward); wall times, each direction's launches, peak memory
   and a profiled forward and forward+backward by kernel;
6. the tuner (``repro_torch.tuning``): (6a) ``mode="model"`` at full
   width, no execution, on croft-1024 and croft-4096 over
   ``{data: 2, model: 2}`` and ``{data: 2, model: 4}``, c2c, r2c and
   c2c_grad, the option space and (c2c) the schedule search, each pick
   with its modeled us, candidate count and host ms; then one timed call
   of each local 1-D FFT implementation at (2^20, 1024), the cost
   model's priors; (6b) ``mode="measure"`` on phase 3's 4 gloo ranks at
   256^3 (pencil 2x2 mesh): c2c top 4, r2c top 2 and c2c_grad top 2,
   each plus the default, every rank picking the same winner (an
   all-gather of its plan key), each race's table (label, modeled us,
   the slowest rank's ms), no candidate dropped (``tune_measure_failures``
   stays 0); then ``measure_candidate`` of the c2c winner
   with ``local_impl="pallas"`` (``fft4step``), of the model's best ring
   candidate (``rotate_blocks``) and of its best packed r2c candidate
   with ``pallas`` (``unpack_two_for_one``), each beside the winner's
   time; (6c) the c2c race's wisdom, written by rank 0, rebuilt with
   ``Croft3D(tune="wisdom")`` on every rank with no new measurement: its
   forward against ``torch.fft.fftn``'s slice (5e-4 * max|ref|), its
   round trip (< 1e-4), its counted collectives equal to
   ``predicted_collectives`` and its counted bytes within 5 % of
   ``comm_bytes_model()`` (of the (P-1)/P a ring or pairwise stage
   sends), and ``forward_filtered_batched`` at B = 2 bitwise equal to
   two ``forward_filtered`` calls (``spectral_scale_full``); the r2c
   race's wisdom plan against ``torch.fft.rfftn``'s slice (5e-5 *
   max|ref|), and one gradient of the c2c_grad race's wisdom plan
   against Parseval's 2 N x (1e-3 of max|ref|); phase 6's own seconds;
7. the transform service (``repro_torch.serve``): (7a) meshless at
   512^3, ``transforms_main``'s mix and inverse requests against
   ``torch.fft``, then one croft-1024 request; (7b) SPMD on 4 gloo ranks
   at 256^3 with a wisdom file of ``pallas`` plans: upgrade, eviction,
   ``exec.output`` quarantine, the batching gate;
8. per-stage overlap attribution (``repro_torch.obs.instrument``) on
   phase 3's 4 gloo ranks at 256^3 under one tracer: ``trace_forward``
   of the acceptance plans ``alltoall-k2`` and ``ring-k1`` (both
   ``local_impl="pallas"``) and a ``Croft3D.tuned(mode="model")`` plan,
   each output against ``plan.forward`` (5e-4 * max|ref|), every rank's
   summary equal, one row per schedule stage, an efficiency in [0, 1]
   for both acceptance plans, round 1 timed on each ring stage; then
   rank 0 serves 5 ragged requests (``max_batch`` 4) meshless under the
   same tracer and saves it to ``build/phase8_trace.json``, which
   must pass the trace smoke's checks (``benchmarks/trace_smoke.py``:
   schema, one stage span per stage, the five lifecycle spans, both
   efficiencies) and render with ``repro_torch.obs.report``, whose
   per-stage tables are printed; C and the efficiencies are gloo's;
9. the FNet spectral mixer (``repro_torch.models.spectral``): (9a) the
   fnet-350m encoder forward at full width and depth (24 layers, bf16,
   weights drawn on the card from the seed) at prefill_32k's sequence of
   32768 and batch 2 (cut from 32): wall, profiled device time by
   kernel, peak memory, finite logits; (9b, in phase 8's ranks)
   ``distributed_seq_fft`` over the 2x2 mesh at (2, 4096, 1024)
   against the local ``spectral_mixer`` (2e-4 * max|ref|); (9c)
   ``examples/serve_lm_torch.py``'s service path, 4 users x 2 mixer
   layers at 4096 x 1024, against the direct call;
10. MLA, the latent cache and the MoE FFN (``repro_torch.models.moe``):
   (10a) deepseek-v2-236b at full width, depth cut to the dense layer 0
   and 3 MoE layers (13.3e9 parameters, bf16, weights drawn on the card
   from the seed): ``make_serve_steps`` prefill of a 2 x 4096
   ``synth_tokens`` prompt and 32 greedy tokens (MLA on the plain
   blockwise core: its head dims are past the kernel's), finite logits;
   wall, profiled device time by kernel of the prefill and of one decode
   step, peak memory, the pairs the MoE layers drop at the config's
   capacity (with each layer's most-loaded expert over the mean load and
   the mean cosine of its hidden states to their mean); then, on the same weights at capacity factor 16 (where no
   pair drops: a decode step never drops, so teacher forcing holds only
   there), a prefill whose first decode step is within 5e-2 * max|ref|
   of the bf16 train pass over the prompt and its first token, and a
   float32 teacher-forcing check at full width with 1 dense + 1 MoE
   layer and S = 1024 (2e-4 * max|ref|); (10b) mixtral-8x22b at full
   width, 4 layers (cut from 56): prefill 2 x 6144 (past the 4096-token
   window) and 32 tokens, 4 ``flash_attention`` launches in the prefill,
   all on the bf16 tensor-core variant, none in the decode, layer 0's
   prefill q, k, v held against the plain version as in 1c, the same
   5e-2 check at capacity factor 4 (E / top_k: the capacity is the token
   count); (10c) the expert-parallel dispatch
   (``moe_fwd_sharded``, mode "ep") on 4 gloo ranks on the one card, a
   (data 1, model 4) mesh at deepseek's expert widths (160 experts, d
   5120, f 1536, top-6, 2 shared), float32, capacity factor 16, (1, 256)
   tokens a rank: each rank's output within 1e-5 * max|ref| of its slice
   of the meshless ``moe_fwd``, its counted collectives;
11. head_dim-256 attention, the dense configs and the recurrent layers:
   (11a) ``gqa_fwd`` over a segment at 0 at head_dim 256 and 128 (8 heads
   over 4, 2 x 1024, window 1024 and none), float32 and bf16, against the
   same call on the CPU in float32 (5e-5; bf16 2^-6 * max|want| + 5e-5):
   no ``flash_attention`` launch at 256 (the blockwise core), one at 128
   (``wgmma`` for bf16); then, each at full width with seeded bf16
   weights, a 2 x 4096 ``synth_tokens`` prompt and 32 greedy tokens,
   wall, profiled device time by kernel of the prefill and of one decode
   step (against the weights' bytes over the memory rate), peak memory,
   and the first decode step of a fresh prefill within 5e-2 * max|ref| of
   the bf16 train pass: (11b) gemma3-4b, 34 layers (head_dim 256: no
   kernel launch); (11c) yi-9b, 48 layers, and yi-34b cut to 16 layers
   (9.84e9 parameters; 60 layers are 137 GB of fp32 masters), one
   ``flash_attention`` launch a layer in the prefill, all ``wgmma``, none
   in the decode, layer 0's q, k, v held against the plain version;
   (11d) recurrentgemma-9b, 38 layers (RG-LRU and head_dim-256 local
   attention: no kernel launch) and (11e) rwkv6-3b, 32 layers, each with
   one full-width float32 mixer's 256 decode steps against its prefill
   (3e-5 RG-LRU, 3e-4 RWKV-6) and float32 teacher forcing (2e-4 *
   max|ref|, S 1024) at one [rglru, rglru, attn] group or 2 RWKV layers;
   (11f, run by 10c's ranks after the dispatch) ``cp_vector_recurrence``
   at (2, 4096, 4096) and ``cp_matrix_recurrence`` at (2, 4096, 40, 64),
   each rank's block within 1e-5 / 1e-4 of its slice of the meshless
   scan, and the counted collectives (2 Hillis-Steele rounds and a shift
   of the (decay, contribution) pair, one all-reduce);
12. the encoder, cross-attention and prefix-LM serving, each at full
   width and depth with seeded bf16 weights, 8 requests and 32 greedy
   tokens: (12a) whisper-base (6 encoder + 6 decoder layers, d 512),
   1500 stub frames a request (seeded normals on the card) and a
   224-token ``synth_tokens`` prompt: ``encode`` timed alone, the
   prefill (which encodes) with exactly 12 ``flash_attention`` launches,
   all ``wgmma`` (6 non-causal in the encoder, 6 causal in the decoder),
   none a decode step, layer 0's encoder q, k, v held against the plain
   version, layer 0's cross cache against ``gqa_project_kv`` of the
   encoder memory (1e-5 * max|ref|), the decode step's busy time against
   the bytes of the weights and the cross K/V over the memory rate,
   bf16 teacher forcing (5e-2) and float32 teacher forcing at full
   depth, S 224 (2e-4); (12b) paligemma-3b (18 layers, d 2048, tied
   257216-token vocabulary) with 256 stub patch embeddings ahead of a
   256-token prompt: no ``flash_attention`` launch (prefix-LM, head_dim
   256), the train pass's logits over the token positions only, bf16
   teacher forcing, float32 teacher forcing at 2 layers over 256 + 512
   positions; wall, device time by kernel of the prefill and of one
   decode step, peak memory for both;
13. training: (13a) the learned spectral filter at croft-1024 (packed
   r2c ``Croft3D``, ``local_impl="pallas"``, meshless): the target from
   seeded true params, step 0's loss and gate and filter gradients
   against the same loss through ``torch.fft.rfftn`` autograd (1e-4 *
   max|ref|), then 5 SGD steps at 0.05 from the identity init, each
   profiled (wall, device busy time, device ops, launches), the loss
   falling and ``fft4step``, ``unpack_two_for_one`` and
   ``spectral_scale_full`` launched in every step, and the peak; (13b)
   h2o-danube-3-4b at full width and depth (24 layers, 3.96e9
   parameters), fp32 masters, bf16 compute and moments, remat on, 5
   ``make_train_step`` steps on ``SyntheticDataset`` batches of 2 x
   (2048 + 1) at AdamW rate 3e-5, each profiled, the top kernels of the
   last, the 6·N·tokens bound over the bf16 peak and the share of it,
   the peak; finite losses, the last below the first, no
   ``flash_attention`` launch; then, as a reading, the same 5 steps at
   the issue's rate 3e-4; (13c) the same model at 2 layers in
   float32, batch 1 x 256: ``loss_fn`` and every gradient leaf on the
   card against the CPU from one seeded state (1e-4 * max|ref|), then
   one full ``make_train_step`` at 3e-4 on both: the scalars within
   1e-5, both moments within 1e-4 * max|ref|, the card's masters
   within 1e-5 * max|ref| of the AdamW formula on its own moments, and
   card against CPU within 2·lr; (13d)
   the 2-layer cut in bf16: 4 straight steps against 2 steps, a
   ``CheckpointManager`` save into a temporary directory (removed
   after), a restore into a fresh state and 2 more (the losses of steps
   3-4 within rtol 1e-6);
14. the LM on a mesh: 4 gloo ranks on the one card, a (data 2, model
   2) mesh from ``make_local_mesh``.  (14a) h2o-danube-3-4b at full
   width in float32, 2 layers, global batch 2 x (1024 + 1): every rank
   draws the seeded model and keeps its blocks (``init_train_state
   (mesh=)``); step 0's loss within rtol 2e-4 of the meshless
   ``make_train_step`` on the card (the parent's, from the same seeded
   state), each rank's gradient blocks within 1e-4 * max|ref| of their
   slices of the meshless gradient, two steps' losses within rtol
   2e-4, each step's counted collectives and wall time; then bf16 at 4
   layers, 5 steps at AdamW 3e-5: finite losses, the last below the
   first, each within rtol 5e-2 of the meshless steps on the card, each
   rank's peak, rank 0's device busy time; (14b) serving
   the same model in bf16 at 4 layers, the whole model on every rank:
   a 2 x 4096 ``synth_tokens`` prefill (2048 positions a rank, the
   4096-slot ring cache 2048 slots a rank) and 32 greedy decode steps;
   the first decode step's logits within 5e-2 * max|ref| of the
   meshless serve from the same weights and token, and in float32 at 2
   layers 8 decode steps within 2e-4 * max|ref|; one decode step
   counted: only the partial-softmax combine, no collective as large as
   a slot block; the sharded prefill's ``flash_attention`` launches;
   (14c) the routes ``forward`` gained, the whole float32 model on
   every rank: mixtral-8x22b at full
   width, 1 layer, "ep" mode at capacity factor 4, and
   recurrentgemma-9b at full width, one ``[rglru, rglru, attn]`` group
   (RG-LRU over the sequence axis with the conv halo), each a 2 x 2048
   prefill whose logits (every 16th position) are held within 2e-4 *
   max|ref| of the meshless forward's on the card, with the counted
   collectives;
15. the last modules: (15a) ``compressed_psum`` on 4 gloo ranks on the
   card (a ``pod`` axis of 4): each rank's meshless step-0 and step-1
   float32 gradients of 14a's model (h2o-danube-3-4b at full width, 2
   layers) on its own seeded 2 x 1024 batch, two error-feedback rounds,
   each leaf of the reduction within 4·amax/127 (``tests/test_parallel
   .py:120``) of an exact float32 sum over the ranks, dequant(q) + res
   within 1e-6 * max|x| of x + res_prev, the counted all-reduces beside
   the float32 all-reduce's; (15b) ``pipeline_apply`` on the same ranks
   (``stage_axis="pod"``, 4 microbatches) over 8 of h2o-danube-3-4b's
   decoder layers at full width, one layer through
   ``torch.func.functional_call`` on a template layer with the stacked
   leaves, each rank holding only its own 2 layers (``local=True``):
   a bf16 no-grad 4 x 1024 forward that launches ``flash_attention`` 2
   layers x 4 microbatches on every stage (32 in all), held within 5e-2
   * max|ref| (phase 4's bf16 bound at depth) of a sequential pass on
   the card whose attention is the kernel's plain version (no kernel
   launch), each stage's busy and wall time (on gloo) beside the bubble
   fraction 3/7 and its peak device memory beside the whole stack's
   bytes; then the float32 gradient of sum(y^2) at 4 x 512 (every
   rank's loss checked equal), each rank's block of every stacked leaf
   within 1e-4 * max|ref| (``tests/test_pipeline.py:53``) of the
   sequential gradient; (15c) the multi-pod dry run in a process of its
   own, on the CPU over fake process groups, while 15a and 15b run:
   ``lower_fft_cell("fft_1024")`` on 16x16 (8 all-to-alls of
   ``comm_model_bytes``), the fake count of 14a's float32 step on a (2,
   2) world equal to what 14a's rank 0 counted, kind by kind, and the
   ``yi-9b decode_32k`` cell on 16x16 with its host seconds and roofline
   record;
16. one JSON line on the kernels, the card's name and power limit, and
   the result line.

Launch counts are set to 0 just before each main-path phase (1d's round
trip, 2, 2b, 3,
3b, 3g, 3c, 4, 5, each race and ``measure_candidate`` of 6b, 6c, 7a,
7b, 8, 9a's timed forward and 9c, each prefill and decode run of 10a,
10b, 11b-11e, 12a and 12b, 10c's dispatch, each step of 13a and 13b,
13c's card pass, 13d's runs, each sharded step, prefill and decode
run of 14, 15b's pipelined forward; in 3g and 5 before each backward
too) and read just after it.

Exits non-zero, printing no result, when there is no CUDA device or any
phase fails.  ``python3 chip_smoke.py --phases sharded last_modules``
builds the kernels and runs only the named phases (``phase_<name>``
taking the device), printing no result line.
"""

from __future__ import annotations

import json
import math
from collections import Counter
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.configs.croft_fft import croft_1024  # noqa: E402
from repro_torch.launch.roofline import (HBM_BW, PEAK_FLOPS,  # noqa: E402
                                         PEAK_FLOPS_FP32)

SEED = 0
FULL = croft_1024().grid[0]  # 1024: the paper's croft-1024 grid
DIST = 256             # phase-3 grid: 4 ranks share one card's memory and wire
RANKS = 4
CELL_RANKS = 8         # phase 3c: a 2x2x2 mesh on the one card
HALF = 512             # c2c forward_filtered grid of phase 2b
ARCH = "h2o-danube-3-4b"  # src/repro/configs/h2o_danube3_4b.py
BATCH = 2              # phase-4 sequences
PROMPT = 6144          # phase-4 prompt: past the model's 4096-token window
GEN = 32               # phase-4 greedy tokens
KV_BLOCK = 512         # the serve CLI's default
TF_LAYERS = 2          # depth of the float32 teacher-forcing check
TF_TOL = 2e-4          # tests/test_models_smoke.py:111-113
BF16_TF_TOL = 5e-2     # tests/test_torch_lm_serve.py, bf16 serving
FFT_TOL = 3e-4         # tests/test_kernels_fft.py:18
FFT3_TOL = 5e-4        # tests/test_kernels_fft.py:78
RT_TOL = 1e-4          # tests/test_distributed_fft.py:28
HERM_TOL = 1e-6        # tests/test_real_fft.py:149
SCALE_TOL = 1e-5       # tests/test_kernels_fft.py:68
DFT_TOL = 1e-5         # tests/test_torch_cuda_kernels.py: DFT_TOL
RFFT_TOL = 5e-5        # tests/test_real_fft.py:160
GRAD_TOL = 1e-4        # tests/test_grad.py:110 (relative to max|ref|)
PARSEVAL_TOL = 1e-3    # tests/test_schedule.py:648
DIST_R2C_TOL = 1e-5    # tests/test_real_fft.py:338
ATTN_TOL = 5e-5       # tests/test_kernels_fft.py:103 (float32, absolute)
# bfloat16, per element: ATTN_BF16_REL·|want| + ATTN_TOL.  Both sides work
# in float32 and round the result to bf16 at the end, each within 2**-8
# of the value, so two ulps of the value are room to spare
ATTN_BF16_REL = 2.0 ** -6
# the H100 SXM's device memory rate, FP32 and bf16 dense peaks
HBM_BYTES_S, FP32_FLOP_S, BF16_FLOP_S = HBM_BW, PEAK_FLOPS_FP32, PEAK_FLOPS
TIMEOUT_S = 900


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after a warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_batched_ms(fns, launches: int = 100, reps: int = 5,
                    warmup: int = 3) -> float:
    """Device time of one call of a short kernel: the median over ``reps``
    of one CUDA-event pair around ``launches`` back-to-back calls, over
    ``launches``.  A sleep kernel ahead of the start event holds the card
    while the host enqueues the calls, so the host's own time per call
    never shows as device time.  ``fns`` is one call, or a list of the
    same call on different inputs, taken in turn: inputs that fit in the
    H100's 50 MB L2 come as several copies whose total is well past it, so
    each call finds its input cold, as a ring stage finds the block it
    just received."""
    import torch
    calls = fns if isinstance(fns, (list, tuple)) else [fns]
    for k in range(max(warmup, len(calls))):
        calls[k % len(calls)]()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)       # ~10 ms at the H100's clock
        start.record()
        for k in range(launches):
            calls[k % len(calls)]()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def host_us(fn, calls: int = 1000) -> float:
    """Host microseconds per call: ``time.perf_counter`` around ``calls``
    calls with no synchronize in between (the card runs behind)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return t


def bound_ms(nbytes: float, flops: float,
             flop_s: float = FP32_FLOP_S) -> tuple[float, str]:
    tb, tf = nbytes / HBM_BYTES_S * 1e3, flops / flop_s * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def max_abs_diff(a, b, step: int = 64) -> float:
    """max |a - b| slab by slab along dim 0 (bounded temporaries)."""
    return max((a[i:i + step] - b[i:i + step]).abs().max().item()
               for i in range(0, a.shape[0], step))


def max_abs(a, step: int = 64) -> float:
    return max(a[i:i + step].abs().max().item()
               for i in range(0, a.shape[0], step))


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"FAILED: {what}")


# ---------------------------------------------------------------------------
# phase 1: kernel parity and timing
# ---------------------------------------------------------------------------

def phase_fft_axes(x) -> dict:
    """``fft4step_axis`` on each axis of the 1024^3 volume x, where the
    axis lies (outer, N, inner) = (2^20, 1024, 1), (1024, 1024, 1024) and
    (1, 1024, 2^20): each held against its plain version and timed beside
    ``torch.fft.fft(x, dim=axis)`` and the bytes bound."""
    import torch
    from repro_torch.kernels import fft_matmul
    n = x.shape[-1]
    nbytes = 2 * x.numel() * 8 + 3 * n * 8
    b_ms, b_by = bound_ms(nbytes, 5.0 * n * math.log2(n) * x.numel() / n)
    out = {}
    for axis in (-1, -2, -3):
        y = fft_matmul.fft4step_axis(x, axis, -1)
        ref = fft_matmul.fft4step_axis_plain(x, axis, -1)
        err, top = max_abs_diff(y, ref), max_abs(ref)
        del y, ref
        torch.cuda.empty_cache()
        check(err <= FFT_TOL * top, f"fft4step axis {axis}")
        out[axis] = dict(
            ms=time_ms(lambda: fft_matmul.fft4step_axis(x, axis, -1)),
            library_ms=time_ms(lambda: torch.fft.fft(x, dim=axis)),
            bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
            tol=FFT_TOL * top)
        print(f"[1] fft4step_axis {tuple(x.shape)} axis {axis}: "
              f"{out[axis]}", flush=True)
    return out


def phase_kernels(dev) -> dict:
    import torch
    from repro_torch.kernels import fft_matmul
    gen = torch.Generator(device=dev).manual_seed(SEED)
    out = {}

    worst = 0.0
    for n in (16, 64, 256, 1024, 4096):
        rows = min(1 << 20, (1 << 30) // n)     # at most an 8 GiB batch
        x = torch.randn(rows, n, dtype=torch.complex64, device=dev,
                        generator=gen)
        for sign in (-1, 1):
            y = fft_matmul.fft4step(x, sign)
            ref = fft_matmul.fft4step_plain(x, sign)
            torch.cuda.synchronize()
            err = max_abs_diff(y, ref, 1 << 14)
            tol = FFT_TOL * max_abs(ref, 1 << 14)
            print(f"[1] fft4step N={n} rows={rows} sign={sign:+d} "
                  f"max_abs_err={err:.3e} tol={tol:.3e}", flush=True)
            check(err <= tol, f"fft4step N={n} sign={sign}")
            if n == FULL:
                worst = max(worst, err)
            del y, ref
        if n == FULL:
            axes = phase_fft_axes(x.view(FULL, FULL, FULL))
            worst = max(worst, *(a["max_abs_err"] for a in axes.values()))
            # the main path's shape: one axis of the 1024^3 grid
            k_ms = time_ms(lambda: fft_matmul.fft4step(x, -1))
            p_ms = time_ms(lambda: fft_matmul.fft4step_plain(x, -1))
            l_ms = time_ms(lambda: torch.fft.fft(x))
            nbytes = 2 * x.numel() * 8 + 3 * n * 8
            b_ms, b_by = bound_ms(nbytes, 5.0 * n * math.log2(n) * rows)
            out["fft4step"] = dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                                   bound_ms=b_ms, bound_by=b_by,
                                   shape=[rows, n])
        if n == DIST:
            # phase 3's shape: one rank's 256^3/4 block (32 MiB), one axis;
            # three disjoint blocks timed in turn, 96 MiB past the L2
            m = DIST * DIST // 4
            xs = [x[i * m:(i + 1) * m] for i in range(3)]
            b_ms, b_by = bound_ms(2 * xs[0].numel() * 8 + 3 * n * 8,
                                  5.0 * n * math.log2(n) * m)
            k_ms = time_batched_ms([lambda a=a: fft_matmul.fft4step(a, -1)
                                    for a in xs])
            l_ms = time_batched_ms([lambda a=a: torch.fft.fft(a) for a in xs])
            print(f"[1] fft4step at {tuple(xs[0].shape)}: ms={k_ms} "
                  f"plain_ms="
                  f"{time_ms(lambda: fft_matmul.fft4step_plain(xs[0], -1))} "
                  f"library_ms={l_ms} bound_ms={b_ms} bound_by={b_by}",
                  flush=True)
        del x
        torch.cuda.empty_cache()
    out["fft4step"]["max_abs_err"] = worst
    out["fft4step"]["axes"] = axes
    print(f"[1] fft4step at ({1 << 20}, {FULL}): {out['fft4step']}", flush=True)
    return out


def phase_dft_rows(dev) -> tuple[dict, dict]:
    """``dft_rows``, the default plan's contiguous axis in one pass, at the
    main path's shape (2^20 rows of 1024 points, the 32 x 32 split) with
    both signs, and on a K-chunk's rows 2048 apart: each held within
    DFT_TOL * max|ref| of its plain version (cuBLAS's three steps, TF32
    off: a TF32 product misses it by two orders) and of ``torch.fft.fft``,
    then timed beside both and its bounds.  Then a ``Croft3D(shape)``
    round trip under ``FFTOptions()`` at 1024^3, which launches it once a
    transform.  Returns ({"dft_rows": row}, the round trip's launches)."""
    import torch
    from repro_torch.core import Croft3D, FFTOptions
    from repro_torch.core import plan as plan_lib
    from repro_torch.device import full_fp32_matmul
    from repro_torch.kernels import dft_rows, launch_counts, \
        reset_launch_counts
    full_fp32_matmul(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    rows = 1 << 20
    x = torch.randn(rows, FULL, dtype=torch.complex64, device=dev,
                    generator=gen)
    worst = 0.0
    tables = {}
    for sign in (-1, 1):
        p = plan_lib.make_plan(FULL, sign)
        w1, w2, _ = p.constants_torch(dev)
        tables[sign] = (w1, w2, p.twiddles_t_torch(dev))
        chunk = x.view(rows // 2, 2 * FULL)[:, :FULL]
        for what, v in (("rows", x), ("k_chunk", chunk)):
            if what == "k_chunk" and sign == 1:
                continue
            got = dft_rows.dft_rows(v, *tables[sign])
            for ref_name, ref in (
                    ("plain", lambda: dft_rows.dft_rows_plain(v, *tables[sign])),
                    ("torch.fft", lambda: torch.fft.fft(v) if sign == -1
                     else torch.fft.ifft(v) * FULL)):
                want = ref()
                err = max_abs_diff(got, want, 1 << 14)
                tol = DFT_TOL * max_abs(want, 1 << 14)
                del want
                print(f"[1d] dft_rows {what} {tuple(v.shape)} stride "
                      f"{v.stride(0)} sign={sign:+d} vs {ref_name}: "
                      f"max_abs_err={err:.3e} tol={tol:.3e}", flush=True)
                check(err <= tol, f"dft_rows {what} sign={sign} vs {ref_name}")
                worst = max(worst, err)
            del got
            torch.cuda.empty_cache()
    n1, n2 = tables[-1][0].shape[0], tables[-1][1].shape[0]
    nbytes = 2 * x.numel() * 8 + (n1 * n1 + n2 * n2 + FULL) * 8
    # the table's rule (5 N log2 N a row) and the dense products' own
    b_ms, b_by = bound_ms(nbytes, 5.0 * FULL * math.log2(FULL) * rows)
    d_ms, d_by = bound_ms(nbytes, 8.0 * (n1 + n2) * x.numel())
    row = dict(
        ms=time_ms(lambda: dft_rows.dft_rows(x, *tables[-1])),
        plain_ms=time_ms(lambda: dft_rows.dft_rows_plain(x, *tables[-1])),
        library_ms=time_ms(lambda: torch.fft.fft(x)),
        bound_ms=b_ms, bound_by=b_by, dense_bound_ms=d_ms, dense_bound_by=d_by,
        max_abs_err=worst, shape=[rows, FULL], split=[n1, n2])
    print(f"[1d] dft_rows at ({rows}, {FULL}): {row}", flush=True)
    shape = (FULL,) * 3
    field = x.view(*shape)
    plan = Croft3D(shape, opts=FFTOptions())
    torch.cuda.synchronize()
    reset_launch_counts()
    back = plan.inverse(plan.forward(field))
    torch.cuda.synchronize()
    counts = launch_counts()
    rt = max_abs_diff(back, field) / max_abs(field)
    del back, x, field, chunk
    torch.cuda.empty_cache()
    print(f"[1d] Croft3D {shape} FFTOptions() round trip: rel err {rt:.3e}, "
          f"launches {counts}", flush=True)
    check(counts.get("dft_rows") == 2,
          f"dft_rows launches in the default plan's round trip: {counts}")
    check(rt < RT_TOL, f"default plan round trip {rt}")
    return {"dft_rows": row}, counts


def phase_rotate_shapes(dev) -> dict:
    """``rotate_blocks`` at the ring shapes of phase 3 (one rank's 256^3/4
    block): every pack and unpack bitwise against the plain version, then
    the natural rotation and the pack timed beside ``torch.roll``."""
    import torch
    from repro_torch.kernels import transpose_pack
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    out = {}
    d, q = DIST, DIST // 2
    cases = [((d, q, q), 0, 2), ((q, d, q), 1, 2), ((q, q, d), 2, 2),
             ((d, d, d // 4), 0, 4), ((d // 4, d, d), 2, 4)]
    for shape, axis, p in cases:
        x = torch.randn(*shape, dtype=torch.complex64, device=dev,
                        generator=gen)
        for idx in range(p):
            pieces = transpose_pack.pack_pieces(x, axis, idx, p)
            plain = transpose_pack.rotate_block_rows_plain(
                x, math.prod(shape[:axis]), p, x.numel() // p
                // math.prod(shape[:axis]), idx, dst_piece_major=True)
            check(torch.equal(torch.stack(pieces).reshape(-1), plain),
                  f"pack {shape} axis={axis} idx={idx}")
            buf = torch.stack(pieces)
            back = transpose_pack.unpack_pieces(buf, axis, -idx)
            unit = buf[0].numel() // math.prod(shape[:axis])
            plain = transpose_pack.rotate_block_rows_plain(
                buf, math.prod(shape[:axis]), p, unit, -idx,
                src_piece_major=True)
            check(torch.equal(back.reshape(-1), plain) and torch.equal(back, x),
                  f"unpack {shape} axis={axis} idx={idx}")
        block = shape[axis] // p
        check(torch.equal(transpose_pack.rotate_blocks(x, axis, 1, p),
                          torch.roll(x, -block, dims=axis)),
              f"rotate vs roll {shape}")
        outer = math.prod(shape[:axis])
        unit = x.numel() // (outer * p)
        b_ms, b_by = bound_ms(2 * x.numel() * 8, 0.0)
        # three copies of the 32 MiB block, timed in turn (past the L2)
        xs = [x, x.clone(), x.clone()]
        row = dict(
            ms=time_batched_ms([
                lambda a=a: transpose_pack.rotate_blocks(a, axis, 1, p)
                for a in xs]),
            pack_ms=time_batched_ms([
                lambda a=a: transpose_pack.pack_pieces(a, axis, 1, p)
                for a in xs]),
            library_ms=time_batched_ms([
                lambda a=a: torch.roll(a, -block, dims=axis) for a in xs]),
            bound_ms=b_ms, bound_by=b_by,
            vec_bytes=transpose_pack.rotate_path(unit, x.data_ptr(), 0),
            run_bytes=unit * 8, max_abs_err=0.0, shape=list(shape))
        if shape == (q, d, q):      # the kernels line's shape
            row["plain_ms"] = time_batched_ms([
                lambda a=a: transpose_pack.rotate_block_rows_plain(
                    a, q, 2, q * q, 1) for a in xs], launches=20)
            out["rotate_blocks"] = row
        print(f"[1] rotate_blocks {shape} axis={axis} P={p}: bitwise equal; "
              f"{row}", flush=True)
        del x, xs
    torch.cuda.empty_cache()
    return out


def ring_rotations(shape) -> list:
    """The pack and unpack rotations of every ring stage that ``build_c2c``
    gives pencil 2x2 and slab 4 at ``shape`` (natural output, K = 1), as
    (mesh kind, stage, pack or unpack, outer, P, unit)."""
    from repro_torch.core import Decomposition
    from repro_torch.core.schedule import build_c2c
    out = []
    for sizes, names, kind in MESHES:
        sched = build_c2c(Decomposition(kind, names), output_layout="natural")
        axis_sizes = dict(zip(names, sizes))
        for st, pts in zip(sched.stages, sched.points):
            if st.comm_axis is None:
                continue
            blk = pts.comm.local_shape(shape, axis_sizes)
            p = axis_sizes[st.comm_axis]
            piece = list(blk)
            piece[st.split_axis] //= p
            a, c = st.split_axis, st.concat_axis
            out.append((kind, st.name, "pack", math.prod(blk[:a]), p,
                        blk[a] // p * math.prod(blk[a + 1:])))
            out.append((kind, st.name, "unpack", math.prod(piece[:c]), p,
                        piece[c] * math.prod(piece[c + 1:])))
    return out


def phase_rotate_rank_blocks(dev) -> dict:
    """``rotate_blocks`` at croft-1024's rank blocks (1024^3 over 4 ranks,
    2 GiB each): every distinct pack and unpack of the ring stages of
    pencil 2x2 and slab 4, as the stage runs it (piece-major on one side)
    and natural on both sides, beside ``torch.roll`` of the same (outer,
    P, unit) view; bitwise against the plain version."""
    import torch
    from repro_torch.kernels import transpose_pack
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    numel = FULL ** 3 // RANKS
    x = torch.randn(numel, dtype=torch.complex64, device=dev, generator=gen)
    b_ms, b_by = bound_ms(2 * numel * 8, 0.0)
    rows, seen = [], set()
    for kind, stage, side, outer, p, unit in ring_rotations((FULL,) * 3):
        key = (side, outer, p, unit)
        if key in seen:
            continue
        seen.add(key)
        spm, dpm = side == "unpack", side == "pack"
        got = transpose_pack.rotate_block_rows(x, outer, p, unit, 1, spm, dpm)
        want = transpose_pack.rotate_block_rows_plain(x, outer, p, unit, 1,
                                                      spm, dpm)
        check(torch.equal(got, want), f"rotate_blocks 2 GiB {key}")
        del got, want
        v = x.view(outer, p, unit)
        row = dict(
            mesh=kind, stage=stage, side=side, outer=outer, p=p, unit=unit,
            vec_bytes=transpose_pack.rotate_path(unit, x.data_ptr(), 0),
            ms=time_batched_ms(lambda: transpose_pack.rotate_block_rows(
                x, outer, p, unit, 1, spm, dpm), launches=10),
            natural_ms=time_batched_ms(lambda: transpose_pack.rotate_block_rows(
                x, outer, p, unit, 1), launches=10),
            library_ms=time_batched_ms(lambda: torch.roll(v, -1, dims=1),
                                       launches=10),
            bound_ms=b_ms, bound_by=b_by)
        rows.append(row)
        print(f"[1] rotate_blocks 2 GiB rank block: {row}", flush=True)
    # what a plain device-to-device copy of the same bytes takes
    y = torch.empty_like(x)
    copy_ms = time_batched_ms(lambda: y.copy_(x), launches=10)
    del x, v, y
    torch.cuda.empty_cache()
    worst = max(r["ms"] / r["bound_ms"] for r in rows)
    print(f"[1] rotate_blocks 2 GiB: {len(rows)} rotations bitwise equal, "
          f"worst {worst:.3f}x the {b_ms:.3f} ms bound; a plain copy of the "
          f"block (Tensor.copy_) {copy_ms:.4f} ms", flush=True)
    return {"rows": rows, "bound_ms": b_ms, "copy_ms": copy_ms}


def phase_host_overhead(dev) -> dict:
    """Host microseconds per launch of every kernel wrapper, at small
    shapes (the card stays ahead, so only the host path is timed)."""
    import torch
    from repro_torch.core import plan as plan_lib
    from repro_torch.kernels import (dft_rows, fft_matmul, flash_attention,
                                     hermitian, spectral_scale as ss,
                                     transpose_pack)
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    dft = plan_lib.make_plan(1024, -1)
    tables = dft.constants_torch(dev)[:2] + (dft.twiddles_t_torch(dev),)
    c = lambda *s: torch.randn(*s, dtype=torch.complex64, device=dev,
                               generator=gen)
    x, h = c(64, 1024), c(64, 1024)
    packed = c(8, 8, 1024)
    half = hermitian.unpack_two_for_one(packed, 1)
    q = torch.randn(1, 128, 4, 64, device=dev, generator=gen).bfloat16()
    kv = torch.randn(1, 128, 2, 64, device=dev, generator=gen).bfloat16()
    calls = {
        "fft4step": lambda: fft_matmul.fft4step(x, -1),
        "dft_rows": lambda: dft_rows.dft_rows(x, *tables),
        "rotate_blocks": lambda: transpose_pack.rotate_blocks(x, 1, 1, 2),
        "unpack_two_for_one": lambda: hermitian.unpack_two_for_one(packed, 1),
        "hermitian_extend": lambda: hermitian.hermitian_extend(half, 1, 1024),
        "spectral_scale": lambda: ss.spectral_scale_planes(x, h[0]),
        "spectral_scale_full": lambda: ss.spectral_scale_planes_full(x, h),
        "flash_attention": lambda: flash_attention.flash_attention(q, kv, kv),
    }
    out = {name: host_us(fn) for name, fn in calls.items()}
    print(f"[1h] host us per launch (1000 calls, no synchronize, small "
          f"shapes): {json.dumps(out)}", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 2: the main path on one rank, full size
# ---------------------------------------------------------------------------

def is_copy(key: str) -> bool:
    """A device op that only moves elements: PyTorch's copy kernels (what
    ``.contiguous()`` of a permuted view launches) and device memcpys;
    ``torch.cat``'s own kernel is counted apart."""
    k = key.lower()
    return ("copy_kernel" in k or "memcpy" in k) and "cat" not in k


def profile_device(fn, phase: str, what: str, top: int,
                   warmup: int = 0) -> tuple:
    """Run ``fn`` once under the profiler; print its device busy time, the
    copy launches in it and its top kernels; return (busy ms, copies).
    With ``warmup``, that many calls run first inside the profiler's
    warm-up steps and only the last is recorded."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    plan = schedule(wait=0, warmup=warmup, active=1) if warmup else None
    with profile(activities=[ProfilerActivity.CUDA], schedule=plan) as prof:
        for i in range(warmup + 1):
            fn()
            torch.cuda.synchronize()
            if i < warmup:
                prof.step()        # the last call stays in the active step
    rows = sorted(prof.key_averages(), key=lambda e: -e.device_time_total)
    rows = [e for e in rows if e.device_time_total > 0]
    busy = sum(e.device_time_total for e in rows) / 1e3
    copies = [e for e in rows if is_copy(e.key)]
    n_copies = sum(e.count for e in copies)
    print(f"[{phase}] profiled {what}: device busy {busy:.2f} ms, "
          f"{sum(e.count for e in rows)} device ops, {n_copies} copy "
          f"launches ({sum(e.device_time_total for e in copies) / 1e3:.2f} "
          f"ms)", flush=True)
    for e in rows[:top]:
        print(f"[{phase}]   {e.device_time_total / 1e3:8.2f} ms  "
              f"x{e.count:<4d} {e.key[:90]}", flush=True)
    return busy, n_copies


def phase_full(dev) -> dict:
    import torch
    from repro_torch.core import Croft3D, FFTOptions
    from repro_torch.kernels import launch_counts, reset_launch_counts
    gen = torch.Generator(device=dev).manual_seed(SEED)
    shape = (FULL,) * 3
    x = torch.randn(*shape, dtype=torch.complex64, device=dev, generator=gen)
    plan = Croft3D(shape, opts=FFTOptions(local_impl="pallas"))
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    y = plan.forward(x)
    torch.cuda.synchronize()
    t_fwd = time.perf_counter() - t0
    ref = torch.fft.fftn(x)        # oracle only
    err = max_abs_diff(y, ref) / max_abs(ref)
    del ref
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    xb = plan.inverse(y)
    torch.cuda.synchronize()
    t_inv = time.perf_counter() - t0
    counts = launch_counts()
    rt = max_abs_diff(xb, x)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    print(f"[2] Croft3D {shape} pallas: forward {t_fwd * 1e3:.2f} ms, "
          f"inverse {t_inv * 1e3:.2f} ms, rel err vs fftn {err:.3e}, "
          f"round trip {rt:.3e}, launches {counts}, peak {peak:.1f} GiB",
          flush=True)
    check(err < FFT3_TOL, f"1024^3 forward rel err {err}")
    check(rt < RT_TOL, f"1024^3 round trip {rt}")
    check(counts.get("fft4step", 0) > 0, "fft4step not launched")
    del y, xb
    torch.cuda.empty_cache()
    # where one forward's device time goes, by kernel (the launches made
    # here are outside the counted run above)
    busy, copies = profile_device(lambda: plan.forward(x), "2", "forward", 6)
    check(copies == 0, f"{copies} copy launches in the c2c forward")
    del x
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# phase 1b: the real-transform and spectral-epilogue kernels
# ---------------------------------------------------------------------------

def _err_and_scale(got, want) -> tuple[float, float]:
    """(max |got - want|, max |want|), slab by slab."""
    return max_abs_diff(got, want), max_abs(want)


def offset_copy(x):
    """A copy of ``x`` one element into a buffer one element longer: its
    base is 8 bytes past a 16-byte boundary."""
    import torch
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    buf[1:].copy_(x.reshape(-1))
    return buf[1:].view(x.shape)


def phase_real_kernels(dev) -> dict:
    import torch
    from repro_torch.kernels import hermitian, spectral_scale as ss
    from repro_torch.kernels import spectral_scale_op
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    out = {}

    # unpack / extend: small n, then the 1024^3 packed spectrum after
    # pairing along y, (1024, 512, 1024) -> (1024, 1024, 512)
    for shape in ((4096, 8, 16), (512, 16, 64), (128, 32, 256),
                  (FULL, FULL // 2, FULL)):
        c = torch.randn(*shape, dtype=torch.complex64, device=dev,
                        generator=gen)
        s = hermitian.unpack_two_for_one(c, 1)
        want = hermitian.unpack_two_for_one_plain(c, 1)
        err, top = _err_and_scale(s, want)
        print(f"[1] unpack_two_for_one {shape}: max_abs_err={err:.3e} "
              f"tol={HERM_TOL * top:.3e}", flush=True)
        check(err <= HERM_TOL * top, f"unpack_two_for_one {shape}")
        del want
        back = hermitian.hermitian_extend(s, 1, shape[-1])
        want = hermitian.hermitian_extend_plain(s, 1, shape[-1])
        err2, top2 = _err_and_scale(back, want)
        print(f"[1] hermitian_extend {tuple(s.shape)}: max_abs_err="
              f"{err2:.3e} tol={HERM_TOL * top2:.3e}", flush=True)
        check(err2 <= HERM_TOL * top2, f"hermitian_extend {shape}")
        del back, want
        if shape[-1] != FULL:
            continue
        nbytes = 2 * c.numel() * 8                 # read C, write A and B
        b_ms, b_by = bound_ms(nbytes, 8.0 * c.numel())
        rows = [shape[0] * shape[1], shape[2]]
        out[hermitian.UNPACK] = dict(
            ms=time_ms(lambda: hermitian.unpack_two_for_one(c, 1)),
            plain_ms=time_ms(lambda: hermitian.unpack_two_for_one_plain(c, 1)),
            library_ms=None, bound_ms=b_ms, bound_by=b_by, shape=rows,
            max_abs_err=err)
        out[hermitian.EXTEND] = dict(
            ms=time_ms(lambda: hermitian.hermitian_extend(s, 1, FULL)),
            plain_ms=time_ms(lambda: hermitian.hermitian_extend_plain(
                s, 1, FULL)),
            library_ms=None, bound_ms=b_ms, bound_by=b_by, shape=rows,
            max_abs_err=err2)
        del c, s
        torch.cuda.empty_cache()
    for name in (hermitian.UNPACK, hermitian.EXTEND):
        print(f"[1] {name} at ({FULL * FULL // 2}, {FULL}): {out[name]}",
              flush=True)

    # the full-shape spectral scale at the r2c spectrum of the 1024^3 grid
    shape = (FULL, FULL, FULL // 2 + 1)
    x = torch.randn(*shape, dtype=torch.complex64, device=dev, generator=gen)
    h = torch.randn(*shape, dtype=torch.complex64, device=dev, generator=gen)
    x2, h2 = x.view(-1, shape[-1]), h.view(-1, shape[-1])
    y = ss.spectral_scale_planes_full(x2, h2)
    want = ss.spectral_scale_plain(x2, h2)
    err, top = _err_and_scale(y, want)
    print(f"[1] spectral_scale_full {shape}: max_abs_err={err:.3e} "
          f"tol={SCALE_TOL * top:.3e}, bitwise {torch.equal(y, want)}",
          flush=True)
    check(err <= SCALE_TOL * top, "spectral_scale_full")
    check(torch.equal(y, want), "spectral_scale_full is not bitwise plain")
    del y, want
    b_ms, b_by = bound_ms(3 * x.numel() * 8, 8.0 * x.numel())
    out[ss.FULL] = dict(
        ms=time_ms(lambda: ss.spectral_scale_planes_full(x2, h2)),
        plain_ms=time_ms(lambda: ss.spectral_scale_plain(x2, h2)),
        library_ms=time_ms(lambda: torch.mul(x, h)), bound_ms=b_ms,
        bound_by=b_by, shape=list(shape), max_abs_err=err)
    # the same values one element into their buffers (8-byte aligned
    # bases: a scalar head, and vectors that straddle 32-byte sectors)
    xo, ho = offset_copy(x2), offset_copy(h2)
    check(torch.equal(ss.spectral_scale_planes_full(xo, ho),
                      ss.spectral_scale_plain(x2, h2)),
          "spectral_scale_full on offset bases is not bitwise plain")
    out[ss.FULL]["offset_ms"] = time_ms(
        lambda: ss.spectral_scale_planes_full(xo, ho))
    print(f"[1] {ss.FULL} at {shape}: {out[ss.FULL]}", flush=True)
    del h, x2, h2, xo, ho
    torch.cuda.empty_cache()

    # the Poisson multiply at the same shape: -1/k^2 (box 2 pi) computed in
    # the pass from the three wavenumber vectors, x read once, y written once
    k = torch.fft.fftfreq(FULL, d=1.0 / FULL, device=dev)
    kz = torch.fft.rfftfreq(FULL, d=1.0 / FULL, device=dev)
    y = ss.poisson_scale(x, k, k, kz)
    want = ss.poisson_scale_plain(x, k, k, kz)
    err, top = _err_and_scale(y, want)
    print(f"[1] {ss.POISSON} {shape}: bitwise {torch.equal(y, want)}",
          flush=True)
    check(torch.equal(y, want), f"{ss.POISSON} is not bitwise plain")
    del y
    xo = offset_copy(x)
    check(torch.equal(ss.poisson_scale(xo, k, k, kz, 0.25),
                      ss.poisson_scale_plain(x, k, k, kz, 0.25)),
          f"{ss.POISSON} on an offset base is not bitwise plain")
    del want
    b_ms, b_by = bound_ms(2 * x.numel() * 8, 16.0 * x.numel())
    out[ss.POISSON] = dict(
        ms=time_ms(lambda: ss.poisson_scale(x, k, k, kz)),
        plain_ms=time_ms(lambda: ss.poisson_scale_plain(x, k, k, kz)),
        library_ms=None, bound_ms=b_ms, bound_by=b_by, shape=list(shape),
        max_abs_err=err,
        offset_ms=time_ms(lambda: ss.poisson_scale(xo, k, k, kz, 0.25)))
    print(f"[1] {ss.POISSON} at {shape}: {out[ss.POISSON]}", flush=True)
    del x, xo
    torch.cuda.empty_cache()

    # the broadcast spectral scale through spectral_scale_op, (2^20, 1024)
    rows = 1 << 20
    x = torch.randn(rows, FULL, dtype=torch.complex64, device=dev,
                    generator=gen)
    h = torch.randn(FULL, dtype=torch.complex64, device=dev, generator=gen)
    worst = 0.0
    for alpha in (1.0, 0.25):
        y = spectral_scale_op(x, h, alpha, device=dev)
        want = ss.spectral_scale_plain(x, h, alpha)
        err, top = _err_and_scale(y, want)
        print(f"[1] spectral_scale ({rows}, {FULL}) alpha={alpha}: "
              f"max_abs_err={err:.3e} tol={SCALE_TOL * top:.3e}, bitwise "
              f"{torch.equal(y, want)}", flush=True)
        check(err <= SCALE_TOL * top, f"spectral_scale alpha={alpha}")
        check(torch.equal(y, want),
              f"spectral_scale alpha={alpha} is not bitwise plain")
        worst = max(worst, err)
        del y, want
    b_ms, b_by = bound_ms(2 * x.numel() * 8 + FULL * 8, 8.0 * x.numel())
    out[ss.BROADCAST] = dict(
        ms=time_ms(lambda: spectral_scale_op(x, h, 0.25, device=dev)),
        plain_ms=time_ms(lambda: ss.spectral_scale_plain(x, h, 0.25)),
        library_ms=time_ms(lambda: torch.mul(x, h)), bound_ms=b_ms,
        bound_by=b_by, shape=[rows, FULL], max_abs_err=worst)
    xo = offset_copy(x)
    check(torch.equal(ss.spectral_scale_planes(xo, h, 0.25),
                      ss.spectral_scale_plain(x, h, 0.25)),
          "spectral_scale on an offset base is not bitwise plain")
    out[ss.BROADCAST]["offset_ms"] = time_ms(
        lambda: ss.spectral_scale_planes(xo, h, 0.25))
    del xo
    print(f"[1] {ss.BROADCAST} at ({rows}, {FULL}): {out[ss.BROADCAST]}",
          flush=True)
    del x, h
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 1c: the flash-attention kernel
# ---------------------------------------------------------------------------

# (b, sq, skv, h, kv, d, causal, window, dtype name)
ATTN_CASES = (
    # tests/test_kernels_fft.py:84-115: the reference's four and its bf16 case
    (2, 256, 256, 4, 2, 64, True, None, "float32"),
    (1, 128, 256, 8, 8, 32, True, 64, "float32"),
    (1, 256, 256, 2, 1, 64, False, None, "float32"),
    (1, 128, 128, 4, 4, 128, True, 32, "float32"),
    (1, 128, 128, 2, 2, 64, True, None, "bfloat16"),
    # ragged lengths at the model's head_dim and window
    (1, 6145, 6145, 8, 2, 120, True, 4096, "float32"),
    (1, 6145, 6145, 8, 2, 120, True, 4096, "bfloat16"),
    (2, 77, 200, 8, 2, 120, True, 64, "float32"),
    (1, 200, 300, 4, 2, 32, False, 50, "float32"),
    # rows past skv + window - 1 see no valid key: every chunk is walked
    (1, 300, 100, 2, 1, 64, True, 32, "float32"),
    # phase 15b's pipelined microbatch: h2o-danube-3-4b, 1 x 1024
    (1, 1024, 1024, 32, 8, 120, True, 4096, "bfloat16"),
    # whisper-base's encoder self-attention (phase 12a): 1500 frames,
    # non-causal
    (8, 1500, 1500, 8, 8, 64, False, None, "bfloat16"),
    (8, 1500, 1500, 8, 8, 64, False, None, "float32"),
)


def attention_pairs(b, sq, skv, h, causal, window) -> int:
    """Unmasked (query, key) pairs, positions 0..S-1 on both sides."""
    total = 0
    for i in range(sq):
        hi = min(i, skv - 1) if causal else skv - 1
        lo = max(0, i - window + 1) if window is not None else 0
        total += max(0, hi - lo + 1)
    return b * h * total


def attention_err(got, want) -> tuple[float, float]:
    """The largest |got - want| and the largest share of its element's
    tolerance (ATTN_TOL in float32, ATTN_BF16_REL·|want| + ATTN_TOL in
    bfloat16); the kernel passes when the share is at most 1."""
    import torch
    want = want.float()
    diff = (got.float() - want).abs()
    tol = (ATTN_TOL if got.dtype == torch.float32
           else ATTN_BF16_REL * want.abs() + ATTN_TOL)
    return diff.max().item(), (diff / tol).max().item()


def phase_attention_kernel(dev) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import launch_counts
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    before = launch_counts()
    for b, sq, skv, h, kv, d, causal, window, dt in ATTN_CASES:
        dtype = getattr(torch, dt)
        q = torch.randn(b, sq, h, d, device=dev, generator=gen).to(dtype)
        k = torch.randn(b, skv, kv, d, device=dev, generator=gen).to(dtype)
        v = torch.randn(b, skv, kv, d, device=dev, generator=gen).to(dtype)
        got = fa.flash_attention(q, k, v, causal=causal, window=window)
        want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        err, share = attention_err(got, want)
        print(f"[1c] flash_attention b={b} sq={sq} skv={skv} h={h} kv={kv} "
              f"d={d} causal={causal} window={window} {dt}: max_abs_err="
              f"{err:.3e}, worst err/tol {share:.3f}", flush=True)
        check(share <= 1.0 and bool(torch.isfinite(got).all()),
              f"flash_attention {(b, sq, skv, h, kv, d, causal, window, dt)}")
        worst[dt] = max(worst[dt], err)
    after = launch_counts()
    print("[1c] parity launches by variant: " + ", ".join(
        f"{v} {after.get(v, 0) - before.get(v, 0)}" for v in (fa.TC, fa.FFMA)),
        flush=True)

    # the model's shape: the h2o-danube-3-4b prefill, q pre-scaled in bf16
    # as the model passes it (scale 1)
    b, s, h, kv, d, window = 2, PROMPT, 32, 8, 120, 4096
    q = (torch.randn(b, s, h, d, device=dev, generator=gen)
         * d ** -0.5).to(torch.bfloat16)
    k = torch.randn(b, s, kv, d, device=dev, generator=gen).to(torch.bfloat16)
    v = torch.randn(b, s, kv, d, device=dev, generator=gen).to(torch.bfloat16)
    run = lambda: fa.flash_attention(q, k, v, causal=True, window=window,
                                     scale=1.0)
    plain = lambda: fa.flash_attention_plain(q, k, v, causal=True,
                                             window=window, scale=1.0)
    got, want = run(), plain()
    err, share = attention_err(got, want)
    print(f"[1c] flash_attention at the model shape ({b}, {s}, {h}, {d}) "
          f"kv={kv} window={window} bf16: max_abs_err={err:.3e}, worst "
          f"err/tol {share:.3f}, median |want| "
          f"{want.float().abs().median().item():.3e}", flush=True)
    check(share <= 1.0, "flash_attention at the model shape")
    check(fa.variant(q, k, v) == fa.TC, "the model shape is not on wgmma")
    # the yardstick, never on the path: one SDPA call on the same inputs
    # with the causal-window mask
    pos = torch.arange(s, device=dev)
    mask = (pos[None, :] <= pos[:, None]) & (pos[:, None] - pos[None, :]
                                             < window)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib = lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, scale=1.0, enable_gqa=True)
    lib_err = (lib().transpose(1, 2).float() - want.float()).abs().max().item()
    del got, want
    pairs = attention_pairs(b, s, s, h, True, window)
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
    b_ms, b_by = bound_ms(nbytes, 4.0 * d * pairs, BF16_FLOP_S)
    before = launch_counts()
    tc_ms = time_batched_ms(run, launches=20)
    tc_launches = launch_counts().get(fa.TC, 0) - before.get(fa.TC, 0)
    out = {"flash_attention": dict(
        ms=tc_ms, single_call_ms=time_ms(run, reps=10),
        plain_ms=time_ms(plain, reps=3, warmup=1),
        library_ms=time_batched_ms(lib, launches=20), bound_ms=b_ms,
        bound_by=b_by,
        max_abs_err=max(worst["float32"], worst["bfloat16"], err),
        shape=[b, s, h, kv, d], pairs=pairs, library_max_abs_err=lib_err)}
    print(f"[1c] flash_attention at ({b}, {s}, {h}, {d}) kv={kv}: "
          f"{out['flash_attention']}; max_abs_err f32 {worst['float32']:.3e}, "
          f"bf16 {worst['bfloat16']:.3e}", flush=True)
    # the FFMA variant at the same shape, in float32 (what it serves)
    q32, k32, v32 = q.float(), k.float(), v.float()
    ffma = lambda: fa.flash_attention(q32, k32, v32, causal=True,
                                      window=window, scale=1.0)
    before = launch_counts()
    ffma_ms = time_ms(ffma, reps=3, warmup=1)
    ffma_launches = launch_counts().get(fa.FFMA, 0) - before.get(fa.FFMA, 0)
    print(f"[1c] variants at the model shape: {fa.TC} {tc_ms:.3f} ms (bf16, "
          f"{tc_launches} launches), {fa.FFMA} {ffma_ms:.3f} ms (f32, "
          f"{ffma_launches} launches); "
          f"sdpa {out['flash_attention']['library_ms']:.3f} ms, bound "
          f"{b_ms:.3f} ms", flush=True)
    del q, k, v, mask, q32, k32, v32
    # mixtral-8x22b's prefill (phase 10b) and its teacher-forcing train
    # pass: 48 query heads over 8 (group 6) at head_dim 128
    b, h, kv, d, window = 2, 48, 8, 128, 4096
    for s in (MX_PROMPT, MX_PROMPT + 1):
        q = (torch.randn(b, s, h, d, device=dev, generator=gen)
             * d ** -0.5).to(torch.bfloat16)
        k, v = (torch.randn(b, s, kv, d, device=dev,
                            generator=gen).to(torch.bfloat16)
                for _ in range(2))
        got = fa.flash_attention(q, k, v, causal=True, window=window,
                                 scale=1.0)
        want = fa.flash_attention_plain(q, k, v, causal=True, window=window,
                                        scale=1.0)
        err, share = attention_err(got, want)
        print(f"[1c] flash_attention at mixtral's shape ({b}, {s}, {h}, {d}) "
              f"kv={kv} window={window} bf16: max_abs_err={err:.3e}, worst "
              f"err/tol {share:.3f}", flush=True)
        check(share <= 1.0 and bool(torch.isfinite(got).all()),
              f"flash_attention at mixtral's shape {(b, s, h, kv, d)}")
        check(fa.variant(q, k, v) == fa.TC,
              f"mixtral's shape {(b, s, h, kv, d)} is not on wgmma")
        out["flash_attention"]["max_abs_err"] = max(
            out["flash_attention"]["max_abs_err"], err)
        del q, k, v, got, want
    phase_attention_whisper(dev, gen, out["flash_attention"])
    torch.cuda.empty_cache()
    return out


def phase_attention_whisper(dev, gen, row: dict) -> None:
    """Times whisper-base's encoder self-attention (B 8, 1500 frames, 8
    heads over 8, head_dim 64, non-causal, q pre-scaled as the model
    passes it), bf16 and float32, beside one
    ``scaled_dot_product_attention`` call and its bound; bf16 must take
    the tensor-core kernel.  Its parity is held by the two ATTN_CASES rows
    at this shape, and on the model's own inputs in phase 12a.  Three
    copies of the inputs take turns, so each call finds them past the
    50 MB L2."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    b, s, h, kv, d = WHISPER_ATTN
    pairs = attention_pairs(b, s, s, h, False, None)
    for dt, peak in (("bfloat16", BF16_FLOP_S), ("float32", FP32_FLOP_S)):
        dtype = getattr(torch, dt)
        copies = [((torch.randn(b, s, h, d, device=dev, generator=gen)
                    * d ** -0.5).to(dtype),
                   *(torch.randn(b, s, kv, d, device=dev,
                                 generator=gen).to(dtype) for _ in range(2)))
                  for _ in range(3)]
        q, k, v = copies[0]
        which = fa.variant(q, k, v)
        if dtype == torch.bfloat16:
            check(which == fa.TC, "whisper's encoder shape is not on wgmma")
        runs = [lambda q=q, k=k, v=v: fa.flash_attention(
            q, k, v, causal=False, scale=1.0) for q, k, v in copies]
        libs = [lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            scale=1.0) for q, k, v in copies]
        # q, k and v read once, the output (q's shape) written once
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        b_ms, b_by = bound_ms(nbytes, 4.0 * d * pairs, peak)
        ms = time_batched_ms(runs, launches=21)
        lib_ms = time_batched_ms(libs, launches=21)
        plain_ms = time_ms(lambda: fa.flash_attention_plain(
            q, k, v, causal=False, scale=1.0), reps=3, warmup=1)
        print(f"[1c] flash_attention at whisper's encoder shape ({b}, {s}, "
              f"{h}, {d}) kv={kv} non-causal {dt}: {which}; {ms:.4f} ms, "
              f"sdpa {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), plain "
              f"{plain_ms:.3f} ms", flush=True)
        row[f"whisper_{dt}"] = dict(ms=ms, library_ms=lib_ms, bound_ms=b_ms,
                                    bound_by=b_by, plain_ms=plain_ms)
        del copies, q, k, v, runs, libs


# ---------------------------------------------------------------------------
# phase 2b: the spectral-solver path on one rank, full size
# ---------------------------------------------------------------------------

def _wall(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def phase_real_full(dev) -> dict:
    import torch
    from repro_torch.core import Croft3D, FFTOptions, poisson_solve
    from repro_torch.kernels import (launch_counts, reset_launch_counts,
                                     spectral_scale_op)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    shape = (FULL,) * 3
    x = torch.randn(*shape, device=dev, generator=gen)
    plan = Croft3D(shape, problem="r2c", strategy="packed",
                   opts=FFTOptions(local_impl="pallas"))
    kz = torch.fft.rfftfreq(FULL, d=1.0 / FULL, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    y, t_fwd = _wall(lambda: plan.forward(x))
    ref = torch.fft.rfftn(x)       # oracle only
    err = max_abs_diff(y, ref) / max_abs(ref)
    xb, t_inv = _wall(lambda: plan.inverse(y))
    rt = max_abs_diff(xb, x)
    del y, xb
    u, t_poisson = _wall(lambda: poisson_solve(x, plan))
    # the oracle's multiplier, by the reference's formula (box 2*pi)
    k = torch.fft.fftfreq(FULL, d=1.0 / FULL, device=dev)
    k2 = k[:, None, None] ** 2 + k[None, :, None] ** 2 + kz[None, None, :] ** 2
    inv_k2 = torch.where(k2 == 0, 0.0, -1.0 / torch.where(k2 == 0, 1.0, k2))
    del k2
    ref *= inv_k2
    del inv_k2
    u_ref = torch.fft.irfftn(ref, s=shape)
    del ref
    p_err = max_abs_diff(u, u_ref) / max_abs(u_ref)
    del u_ref
    torch.cuda.empty_cache()
    # d/dz of the solution: the broadcast k-space multiply by i*kz, with
    # the Nyquist mode of the odd derivative zeroed, as spectral codes do
    ikz = torch.complex(torch.zeros_like(kz), kz)
    ikz[-1] = 0
    du, t_dz = _wall(lambda: plan.inverse(spectral_scale_op(
        plan.forward(u), ikz, device=dev)))
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    du_ref = torch.fft.irfftn(torch.fft.rfftn(u) * ikz, s=shape)
    dz_err = max_abs_diff(du, du_ref) / max_abs(du_ref)
    del du, du_ref, u
    torch.cuda.empty_cache()
    print(f"[2b] Croft3D {shape} r2c packed pallas: forward {t_fwd:.2f} ms, "
          f"inverse {t_inv:.2f} ms, poisson_solve {t_poisson:.2f} ms, "
          f"d/dz {t_dz:.2f} ms; rel err vs rfftn {err:.3e}, round trip "
          f"{rt:.3e}, poisson rel err {p_err:.3e}, d/dz rel err "
          f"{dz_err:.3e}; launches {counts}; peak {peak:.1f} GiB",
          flush=True)
    check(err < RFFT_TOL, f"1024^3 r2c forward rel err {err}")
    check(rt < RT_TOL, f"1024^3 r2c round trip {rt}")
    check(p_err < RFFT_TOL, f"1024^3 poisson_solve rel err {p_err}")
    check(dz_err < RFFT_TOL, f"1024^3 d/dz rel err {dz_err}")
    for name in ("fft4step", "unpack_two_for_one", "hermitian_extend",
                 "spectral_scale", "spectral_scale_poisson"):
        check(counts.get(name, 0) > 0, f"{name} not launched in phase 2b")
    # the folded epilogue is the distributed packed pipeline's (phase 3b);
    # a meshless plan refuses it, as the reference does
    try:
        plan.forward_filtered(x, ikz, fold=True)
        check(False, "meshless fold=True did not raise")
    except ValueError as e:
        check("fold_filter" in str(e), f"meshless fold=True: {e}")

    # where one forward's device time goes, by kernel (outside the count)
    profile_device(lambda: plan.forward(x), "2b", "r2c forward", 8)
    del x
    torch.cuda.empty_cache()

    # the c2c epilogue: forward_filtered at 512^3 against fftn * h
    reset_launch_counts()
    shape = (HALF,) * 3
    xc = torch.randn(*shape, dtype=torch.complex64, device=dev, generator=gen)
    h = torch.randn(*shape, dtype=torch.complex64, device=dev, generator=gen)
    cplan = Croft3D(shape, opts=FFTOptions(local_impl="pallas"))
    yf, t_ff = _wall(lambda: cplan.forward_filtered(xc, h))
    c2c_counts = launch_counts()
    ref = torch.fft.fftn(xc) * h
    c_err = max_abs_diff(yf, ref) / max_abs(ref)
    print(f"[2b] c2c forward_filtered {shape}: {t_ff:.2f} ms, rel err "
          f"{c_err:.3e}, launches {c2c_counts}", flush=True)
    check(c_err < FFT3_TOL, f"512^3 c2c forward_filtered rel err {c_err}")
    check(c2c_counts.get("spectral_scale_full", 0) > 0,
          "spectral_scale_full not launched by the c2c epilogue")
    del xc, h, yf, ref
    torch.cuda.empty_cache()
    for name, c in c2c_counts.items():
        counts[name] = counts.get(name, 0) + c
    return counts


# ---------------------------------------------------------------------------
# phase 3: the distributed executor, 4 ranks on one card
# ---------------------------------------------------------------------------

MESHES = (((2, 2), ("data", "model"), "pencil"), ((4,), ("p",), "slab"))


def worker(rank: int, port: int) -> None:
    """One rank of phases 3 and 3b; prints its results as JSON lines."""
    import torch
    from repro_torch.core import make_mesh
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    join_ranks(rank, port, RANKS)
    meshes = [(make_mesh(sizes, names, device=dev), kind, names)
              for sizes, names, kind in MESHES]
    res = worker_c2c(rank, dev, meshes)
    res["pack_profile"] = profile_pack(rank, dev, meshes)
    print("RESULT " + json.dumps(res), flush=True)
    res = worker_r2c(rank, dev, meshes)
    print("RESULT_R2C " + json.dumps(res), flush=True)
    res = worker_grad(rank, dev, meshes)
    print("RESULT_GRAD " + json.dumps(res), flush=True)
    leave_ranks(*(m for m, _, _ in meshes))


def _sq_norm(y):
    """sum |y|^2 as one reduction (no |y| temporary of the field's size)."""
    import torch
    return torch.linalg.vector_norm(y) ** 2


def worker_grad(rank: int, dev, meshes) -> dict:
    """Phase 3's gradients on one rank: on the pencil 2x2 mesh at 256^3,
    ``loss = sum |y|^2`` summed over the ranks, c2c and packed r2c x
    batch 1 and 2 x every transpose impl; every rank calls
    ``backward()``.  x.grad is held against the oracle (c2c: Parseval,
    2 N x; r2c: ``torch.fft.rfftn`` autograd on the whole field) and ring
    and pairwise against alltoall; the backward's launches are counted
    per configuration."""
    import torch
    from repro_torch.core import Croft3D, Decomposition, FFTOptions
    from repro_torch.kernels import launch_counts, reset_launch_counts
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    shape = (DIST,) * 3
    mesh, kind, names = meshes[0]
    dec = Decomposition(kind, names)
    n = float(DIST ** 3)
    res = {"rank": rank, "err": 0.0, "impl_err": 0.0, "bwd_launches": {},
           "fwd_ms": {}, "bwd_ms": {}}
    total = {}
    for problem in ("c2c", "r2c"):
        kw = {} if problem == "c2c" else dict(problem="r2c",
                                              strategy="packed")
        for batch in (1, 2):
            if problem == "c2c":
                x = torch.randn(batch, *shape, dtype=torch.complex64,
                                device=dev, generator=gen)
                want = 2 * n * x
            else:
                x = torch.randn(batch, *shape, device=dev, generator=gen)
                full = x.clone().requires_grad_()
                _sq_norm(torch.fft.rfftn(full, dim=(-3, -2, -1))).backward()
                want = full.grad          # oracle only
            grads = {}
            for impl in ("alltoall", "ring", "pairwise"):
                plan = Croft3D(shape, mesh, dec, FFTOptions(
                    transpose_impl=impl, local_impl="pallas"), **kw)
                sl = (Ellipsis,) + plan.input_sharding
                xl = x[sl].contiguous()
                if batch == 1:
                    xl = xl[0].clone()
                xl.requires_grad_()
                fwd = plan.forward if batch == 1 else plan.forward_batched
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                y = fwd(xl)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                reset_launch_counts()
                _sq_norm(y).backward()
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                tag = f"{kind}/{problem}/b{batch}/{impl}"
                res["bwd_launches"][tag] = launch_counts()
                for name, c in launch_counts().items():
                    total[name] = total.get(name, 0) + c
                res["fwd_ms"][tag] = (t1 - t0) * 1e3
                res["bwd_ms"][tag] = (t2 - t1) * 1e3
                g = xl.grad if batch == 2 else xl.grad[None]
                ref = want[sl]
                err = (g - ref).abs().max().item() / ref.abs().max().item()
                if err >= GRAD_TOL:
                    raise SystemExit(f"rank {rank} {tag}: grad err {err}")
                grads[impl] = g
                res["err"] = max(res["err"], err)
                if impl != "alltoall":
                    if res["bwd_launches"][tag].get("rotate_blocks", 0) == 0:
                        raise SystemExit(f"rank {rank} {tag}: no "
                                         "rotate_blocks in the backward")
                    d = ((g - grads["alltoall"]).abs().max().item()
                         / grads["alltoall"].abs().max().item())
                    if d >= GRAD_TOL:
                        raise SystemExit(f"rank {rank} {tag}: differs from "
                                         f"alltoall by {d}")
                    res["impl_err"] = max(res["impl_err"], d)
    res["launches"] = total
    return res


def worker_r2c(rank: int, dev, meshes) -> dict:
    """Phase 3b on one rank: the packed r2c pipeline on a 256^3 real field,
    every transpose impl x K, forward, inverse and both filter
    placements, against this rank's slice of ``torch.fft.rfftn``."""
    import torch
    from repro_torch.core import Croft3D, Decomposition, FFTOptions
    from repro_torch.kernels import launch_counts, reset_launch_counts
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    shape = (DIST,) * 3
    x = torch.randn(*shape, device=dev, generator=gen)
    ref = torch.fft.rfftn(x)       # oracle only
    scale = ref.abs().max().item()
    k = torch.fft.fftfreq(DIST, device=dev)
    # kz-independent, real and 2-D-even: valid for the folded epilogue
    h = torch.exp(-(k[:, None, None] ** 2 + k[None, :, None] ** 2) * 20
                  ).expand(DIST, DIST, DIST // 2 + 1).to(torch.complex64)
    ref_h = ref * h
    res = {"rank": rank, "err": 0.0, "rt": 0.0, "fwd_ms": {},
           "fwd_launches": {}, "reshard_bytes": 0, "host_staged_bytes": 0}
    for mesh, kind, names in meshes:
        mesh.reshard_bytes = mesh.host_staged_bytes = 0
    reset_launch_counts()
    for mesh, kind, names in meshes:
        dec = Decomposition(kind, names)
        base = {}
        for impl in ("alltoall", "ring", "pairwise"):
            for kk in (1, 2):
                opts = FFTOptions(overlap_k=kk, transpose_impl=impl,
                                  local_impl="pallas")
                plan = Croft3D(shape, mesh, dec, opts, problem="r2c",
                               strategy="packed")
                xl = x[plan.input_sharding].contiguous()
                hl = h[plan.output_sharding].contiguous()
                before = launch_counts()
                y, t = _wall(lambda: plan.forward(xl))
                after = launch_counts()
                tag = f"{kind}/r2c/{impl}/k{kk}"
                res["fwd_launches"][tag] = {
                    n: after.get(n, 0) - before.get(n, 0) for n in after}
                res["fwd_ms"][tag] = t
                outs = {"forward": y, "inverse": plan.inverse(y),
                        "filtered": plan.forward_filtered(xl, hl),
                        "folded": plan.forward_filtered(xl, hl, fold=True)}
                err = max((outs[n] - want[plan.output_sharding]).abs().max()
                          .item() for n, want in (("forward", ref),
                                                  ("filtered", ref_h),
                                                  ("folded", ref_h)))
                rt = (outs["inverse"] - xl).abs().max().item()
                if err >= DIST_R2C_TOL * scale or rt >= RT_TOL:
                    raise SystemExit(f"rank {rank} {tag}: err "
                                     f"{err / scale} rt {rt}")
                for n, v in outs.items():
                    if n not in base:
                        base[n] = v
                    elif not torch.equal(v, base[n]):
                        raise SystemExit(f"rank {rank} {tag} {n}: differs "
                                         "bitwise from alltoall K=1")
                res["err"] = max(res["err"], err / scale)
                res["rt"] = max(res["rt"], rt)
        res["reshard_bytes"] += mesh.reshard_bytes
        res["host_staged_bytes"] += mesh.host_staged_bytes
    res["launches"] = launch_counts()
    return res


def profile_pack(rank: int, dev, meshes) -> dict:
    """One profiled c2c forward per K in {1, 2} on the pencil mesh with the
    ring transpose (outside the counted run): on rank 0, the device time
    and launches of ``rotate_blocks``, the device copy launches, and how
    many packs were handed a non-contiguous block (which
    ``schedule._pack_pieces`` copies with ``.contiguous()`` first)."""
    import contextlib
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import Croft3D, Decomposition, FFTOptions, schedule
    gen = torch.Generator(device=dev).manual_seed(SEED)
    shape = (DIST,) * 3
    x = torch.randn(*shape, dtype=torch.complex64, device=dev, generator=gen)
    mesh, kind, names = meshes[0]
    packs = []
    pack_pieces = schedule._pack_pieces

    def spy(blk, *args):
        packs.append((blk.is_contiguous(), blk.numel() * blk.element_size()))
        return pack_pieces(blk, *args)

    out = {}
    schedule._pack_pieces = spy
    try:
        for k in (1, 2):
            plan = Croft3D(shape, mesh, Decomposition(kind, names),
                           FFTOptions(overlap_k=k, transpose_impl="ring",
                                      local_impl="pallas"))
            xl = x[plan.input_sharding].contiguous()
            plan.forward(xl)
            torch.cuda.synchronize()
            packs.clear()
            ctx = (profile(activities=[ProfilerActivity.CUDA]) if rank == 0
                   else contextlib.nullcontext())
            with ctx as prof:
                plan.forward(xl)
                torch.cuda.synchronize()
            if rank != 0:
                continue
            rows = [e for e in prof.key_averages() if e.device_time_total > 0]
            rot = [e for e in rows if "rotate" in e.key]
            copies = [e for e in rows if is_copy(e.key)]
            out[f"k{k}"] = dict(
                busy_ms=sum(e.device_time_total for e in rows) / 1e3,
                rotate_ms=sum(e.device_time_total for e in rot) / 1e3,
                rotate_launches=sum(e.count for e in rot),
                rotate_kernels=sorted({e.key[:40] for e in rot}),
                copy_launches=sum(e.count for e in copies),
                copy_ms=sum(e.device_time_total for e in copies) / 1e3,
                packs=len(packs),
                packs_copied_first=sum(not c for c, _ in packs),
                bytes_copied_first=sum(b for c, b in packs if not c))
    finally:
        schedule._pack_pieces = pack_pieces
    return out


def worker_c2c(rank: int, dev, meshes) -> dict:
    """Phase 3 on one rank: the c2c matrix at 256^3."""
    import torch
    from repro_torch.core import Croft3D, Decomposition, FFTOptions
    from repro_torch.kernels import launch_counts, reset_launch_counts
    gen = torch.Generator(device=dev).manual_seed(SEED)
    shape = (DIST,) * 3
    x = torch.randn(*shape, dtype=torch.complex64, device=dev, generator=gen)
    ref = torch.fft.fftn(x)        # oracle only
    scale = ref.abs().max().item()
    res = {"rank": rank, "err": 0.0, "rt": 0.0, "fwd_ms": {},
           "fwd_launches": {}, "host_staged_bytes": 0}
    reset_launch_counts()
    for mesh, kind, names in meshes:
        dec = Decomposition(kind, names)
        for layout in ("natural", "spectral"):
            base = None
            for impl in ("alltoall", "ring", "pairwise"):
                for k in (1, 2):
                    for mode in ("pipelined", "unrolled"):
                        opts = FFTOptions(overlap_k=k, transpose_impl=impl,
                                          overlap_mode=mode,
                                          output_layout=layout,
                                          local_impl="pallas")
                        plan = Croft3D(shape, mesh, dec, opts)
                        xl = x[plan.input_sharding].contiguous()
                        torch.cuda.synchronize()
                        before = launch_counts()
                        t0 = time.perf_counter()
                        y = plan.forward(xl)
                        torch.cuda.synchronize()
                        t = (time.perf_counter() - t0) * 1e3
                        after = launch_counts()
                        xb = plan.inverse(y)
                        tag = f"{dec.kind}/{layout}/{impl}/k{k}/{mode}"
                        res["fwd_launches"][tag] = {
                            n: after.get(n, 0) - before.get(n, 0)
                            for n in after}
                        err = (y - ref[plan.output_sharding]).abs().max().item()
                        rt = (xb - xl).abs().max().item()
                        if err >= FFT3_TOL * scale or rt >= RT_TOL:
                            raise SystemExit(f"rank {rank} {tag}: err "
                                             f"{err / scale} rt {rt}")
                        if base is None:
                            base = y
                        elif not torch.equal(y, base):
                            raise SystemExit(f"rank {rank} {tag}: differs "
                                             "bitwise from the first config")
                        res["err"] = max(res["err"], err / scale)
                        res["rt"] = max(res["rt"], rt)
                        res["fwd_ms"][tag] = t
        res["host_staged_bytes"] += mesh.host_staged_bytes
    res["launches"] = launch_counts()
    return res


def spawn_ranks(flag: str, ranks: int, *args,
                timeout: float = TIMEOUT_S) -> list:
    """Run this script's ``flag`` worker as ``ranks`` processes on the one
    card, joined by one gloo group whose rendezvous store this process
    hosts (bound to port 0, so no other process can take the port first;
    it outlives every rank); returns their outputs.  Fails naming every
    rank that failed; kills every rank still running after ``timeout``
    seconds."""
    import datetime
    import torch.distributed as dist
    store = dist.TCPStore("127.0.0.1", 0, None, is_master=True,
                          wait_for_workers=False,
                          timeout=datetime.timedelta(seconds=timeout))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), flag, str(r),
         str(store.port)] + [str(a) for a in args], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(ranks)]
    outs = []
    try:
        deadline = time.time() + timeout
        for p in procs:
            out, _ = p.communicate(timeout=max(1.0, deadline - time.time()))
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        del store
    failed = [r for r, p in enumerate(procs) if p.returncode]
    for r in failed:
        print(f"--- {flag} rank {r} exited {procs[r].returncode}:\n"
              + outs[r][-4000:], file=sys.stderr)
    if failed:
        raise SystemExit(f"FAILED: {flag} ranks {failed} exited non-zero")
    return outs


def join_ranks(rank: int, port: int, world: int) -> None:
    """A worker joins the spawning process's store as ``rank``."""
    import datetime
    import torch.distributed as dist
    store = dist.TCPStore("127.0.0.1", int(port), world, is_master=False,
                          timeout=datetime.timedelta(seconds=TIMEOUT_S))
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)


def leave_ranks(*meshes) -> None:
    """Tear the groups down in one order on every rank, while every rank
    is alive: a barrier, each mesh's groups (``Mesh.close``), then the
    default group.  A group left for interpreter exit to destroy can take
    the process down with it once another rank has gone."""
    import gc
    import torch.distributed as dist
    dist.barrier()
    for mesh in meshes:
        mesh.close()
    dist.destroy_process_group()
    gc.collect()


def _results(outs: list, key: str, phase: str) -> list:
    """Each rank's last ``key`` JSON line."""
    got = []
    for r, out in enumerate(outs):
        lines = [l for l in out.splitlines() if l.startswith(key + " ")]
        if not lines:
            print(out[-4000:], file=sys.stderr)
            raise SystemExit(f"FAILED: phase {phase} rank {r} printed no "
                             f"{key}")
        got.append(json.loads(lines[-1][len(key) + 1:]))
    return got


def _summarize(results: list, phase: str) -> dict:
    counts = {}
    for res in results:
        for name, c in res["launches"].items():
            counts[name] = counts.get(name, 0) + c
    for tag in results[0]["fwd_ms"]:
        t = max(res["fwd_ms"][tag] for res in results)
        print(f"[{phase}] {tag}: forward {t:.1f} ms (slowest rank, host "
              f"clock, gloo), launches per rank "
              f"{results[0]['fwd_launches'][tag]}", flush=True)
    summary = dict(
        err=max(r["err"] for r in results), rt=max(r["rt"] for r in results),
        launches=counts,
        host_staged_bytes=sum(r["host_staged_bytes"] for r in results))
    if "reshard_bytes" in results[0]:
        summary["reshard_bytes"] = sum(r["reshard_bytes"] for r in results)
    print(f"[{phase}] {RANKS} ranks, {DIST}^3: {summary}", flush=True)
    return counts


def phase_distributed() -> tuple[dict, dict, dict]:
    outs = spawn_ranks("--worker", RANKS)
    results, results_r2c, results_grad = (
        _results(outs, key, "3") for key in ("RESULT", "RESULT_R2C",
                                             "RESULT_GRAD"))
    counts = _summarize(results, "3")
    print(f"[3] profiled pencil ring forward, rank 0: "
          f"{json.dumps(results[0]['pack_profile'])}", flush=True)
    check(counts.get("fft4step", 0) > 0, "fft4step not launched in phase 3")
    check(counts.get("rotate_blocks", 0) > 0,
          "rotate_blocks not launched in phase 3")
    counts_r2c = _summarize(results_r2c, "3b")
    for name in ("fft4step", "rotate_blocks", "unpack_two_for_one",
                 "hermitian_extend", "spectral_scale_full"):
        check(counts_r2c.get(name, 0) > 0, f"{name} not launched in phase 3b")
    counts_grad = {}
    for res in results_grad:
        for name, c in res["launches"].items():
            counts_grad[name] = counts_grad.get(name, 0) + c
    for tag in results_grad[0]["bwd_ms"]:
        print(f"[3g] {tag}: forward {max(r['fwd_ms'][tag] for r in results_grad):.1f}"
              f" ms, backward {max(r['bwd_ms'][tag] for r in results_grad):.1f}"
              f" ms (slowest rank, host clock, gloo); backward launches per "
              f"rank {results_grad[0]['bwd_launches'][tag]}", flush=True)
    print(f"[3g] {RANKS} ranks, {DIST}^3 gradients: max rel err "
          f"{max(r['err'] for r in results_grad):.3e} vs the oracle, "
          f"{max(r['impl_err'] for r in results_grad):.3e} ring/pairwise vs "
          f"alltoall; backward launches {counts_grad}", flush=True)
    for name in ("fft4step", "rotate_blocks"):
        check(counts_grad.get(name, 0) > 0,
              f"{name} not launched in phase 3's backward passes")
    return counts, counts_r2c, counts_grad


# ---------------------------------------------------------------------------
# phase 3c: the cell decomposition, a folded axis and the distributed
# embed, 8 ranks on one card
# ---------------------------------------------------------------------------

def worker_cell(rank: int, port: int) -> None:
    """One rank of phase 3c; prints its result as a JSON line."""
    import torch
    from repro_torch.core import Croft3D, Decomposition, FFTOptions, make_mesh
    from repro_torch.kernels import launch_counts, reset_launch_counts
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    join_ranks(rank, port, CELL_RANKS)
    cube = make_mesh((2, 2, 2), ("a", "b", "c"), device=dev)
    flat = make_mesh((2, 4), ("y", "z"), device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    shape = (DIST,) * 3
    x = torch.randn(*shape, dtype=torch.complex64, device=dev, generator=gen)
    xr = torch.randn(*shape, device=dev, generator=gen)
    ref = torch.fft.fftn(x)        # oracles only
    ref_r = torch.fft.rfftn(xr)
    res = {"rank": rank, "err": {}, "rt": {}, "ms": {}}
    reset_launch_counts()
    c2c = [("cell", cube, Decomposition("cell", ("a", "b", "c")), layout)
           for layout in ("natural",)]
    c2c += [("pencil-folded", cube,
             Decomposition("pencil", (("a", "b"), "c")), layout)
            for layout in ("natural", "spectral")]
    for kind, mesh, dec, layout in c2c:
        for k in (1, 2):
            plan = Croft3D(shape, mesh, dec, FFTOptions(
                overlap_k=k, output_layout=layout, local_impl="pallas"))
            xl = x[plan.input_sharding].contiguous()
            y, t = _wall(lambda: plan.forward(xl))
            want = ref[plan.output_sharding]
            tag = f"{kind}/{layout}/k{k}"
            res["err"][tag] = ((y - want).abs().max().item()
                               / ref.abs().max().item())
            res["rt"][tag] = (plan.inverse(y) - xl).abs().max().item()
            res["ms"][tag] = t
            if res["err"][tag] >= FFT3_TOL or res["rt"][tag] >= RT_TOL:
                raise SystemExit(f"rank {rank} {tag}: err {res['err'][tag]} "
                                 f"rt {res['rt'][tag]}")
    for kind, mesh, dec in (
            ("pencil", flat, Decomposition("pencil", ("y", "z"))),
            ("cell", cube, Decomposition("cell", ("a", "b", "c")))):
        plan = Croft3D(shape, mesh, dec, FFTOptions(local_impl="pallas"),
                       problem="r2c", strategy="embed")
        xl = xr[plan.input_sharding].contiguous()
        y, t = _wall(lambda: plan.forward(xl))
        tag = f"{kind}/r2c-embed"
        res["err"][tag] = ((y - ref_r[plan.output_sharding]).abs().max().item()
                           / ref_r.abs().max().item())
        res["rt"][tag] = (plan.inverse(y) - xl).abs().max().item()
        res["ms"][tag] = t
        if res["err"][tag] >= RFFT_TOL or res["rt"][tag] >= RT_TOL:
            raise SystemExit(f"rank {rank} {tag}: err {res['err'][tag]} "
                             f"rt {res['rt'][tag]}")
    # one cell gradient: loss = sum |y|^2 over the ranks, Parseval
    plan = Croft3D(shape, cube, Decomposition("cell", ("a", "b", "c")),
                   FFTOptions(local_impl="pallas"))
    xl = x[plan.input_sharding].contiguous().requires_grad_()
    fwd_before = launch_counts()
    y = plan.forward(xl)
    fwd = {n: c - fwd_before.get(n, 0) for n, c in launch_counts().items()}
    before = launch_counts()
    _, t = _wall(lambda: _sq_norm(y).backward())
    res["bwd_launches"] = {n: c - before.get(n, 0)
                           for n, c in launch_counts().items()}
    res["fwd_launches"] = fwd
    want = 2 * float(DIST ** 3) * xl.detach()
    res["err"]["cell/grad"] = ((xl.grad - want).abs().max().item()
                               / want.abs().max().item())
    res["ms"]["cell/grad backward"] = t
    if res["err"]["cell/grad"] >= PARSEVAL_TOL:
        raise SystemExit(f"rank {rank} cell grad err {res['err']['cell/grad']}")
    res["launches"] = launch_counts()
    res["reshard_bytes"] = cube.reshard_bytes + flat.reshard_bytes
    print("RESULT_CELL " + json.dumps(res), flush=True)
    leave_ranks(cube, flat)


def phase_cell() -> dict:
    results = _results(spawn_ranks("--worker-cell", CELL_RANKS),
                       "RESULT_CELL", "3c")
    counts = {}
    for res in results:
        for name, c in res["launches"].items():
            counts[name] = counts.get(name, 0) + c
    for tag in results[0]["err"]:
        print(f"[3c] {tag}: max rel err {max(r['err'][tag] for r in results):.3e}"
              + (f", round trip {max(r['rt'][tag] for r in results):.3e}"
                 if tag in results[0]["rt"] else "")
              + (f", {max(r['ms'][tag] for r in results):.1f} ms (slowest "
                 "rank, host clock, gloo)" if tag in results[0]["ms"] else ""),
              flush=True)
    print(f"[3c] {CELL_RANKS} ranks, {DIST}^3: cell gradient launches per "
          f"rank forward {results[0]['fwd_launches']} backward "
          f"{results[0]['bwd_launches']}; all launches {counts}; reshard "
          f"bytes {sum(r['reshard_bytes'] for r in results)}", flush=True)
    check(counts.get("fft4step", 0) > 0, "fft4step not launched in phase 3c")
    check(results[0]["bwd_launches"].get("fft4step", 0) > 0,
          "fft4step not launched in the cell backward")
    return counts


# ---------------------------------------------------------------------------
# phase 5: gradients at full width, meshless
# ---------------------------------------------------------------------------

def _grad_run(fn, inputs, what: str, runs: int = 2) -> dict:
    """``loss = sum |fn(*inputs)|^2`` forward, then backward, ``runs``
    times: the first step pays for the allocator's growth and autograd's
    device thread, the last is warm.  Per step: wall times, the device
    time of each direction (CUDA events; the backward's includes the
    loss and its gradient), each direction's launches and the peak
    memory.  Returns the last step's numbers and the launches of all."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    fwd_all, bwd_all = {}, {}
    for step in range(runs):
        for t in inputs:
            t.grad = None
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        t0 = time.perf_counter()
        ev[0].record()
        y = fn(*inputs)
        ev[1].record()
        torch.cuda.synchronize()
        t_fwd = (time.perf_counter() - t0) * 1e3
        fwd = launch_counts()
        reset_launch_counts()
        _sq_norm(y).backward()
        ev[2].record()
        torch.cuda.synchronize()
        t_all = (time.perf_counter() - t0) * 1e3
        del y
        out = dict(fwd=fwd, bwd=launch_counts(), fwd_ms=t_fwd, step_ms=t_all,
                   fwd_dev_ms=ev[0].elapsed_time(ev[1]),
                   bwd_dev_ms=ev[1].elapsed_time(ev[2]),
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        for into, counts in ((fwd_all, out["fwd"]), (bwd_all, out["bwd"])):
            for name, c in counts.items():
                into[name] = into.get(name, 0) + c
        print(f"[5] {what}, step {step + 1} of {runs}: forward "
              f"{t_fwd:.2f} ms, forward+backward {t_all:.2f} ms (wall); "
              f"device forward {out['fwd_dev_ms']:.2f} ms, backward with "
              f"the loss {out['bwd_dev_ms']:.2f} ms (events); launches "
              f"forward {out['fwd']} backward {out['bwd']}; peak "
              f"{out['peak_gib']:.1f} GiB", flush=True)
    out["fwd_all"], out["bwd_all"] = fwd_all, bwd_all
    return out


def _profile_step(fn, inputs, what: str) -> None:
    """Device time by kernel of one forward, then of one forward+backward
    (outside the counted runs), each profiled after one unprofiled
    warm-up call."""
    import torch
    with torch.no_grad():
        profile_device(lambda: fn(*inputs), "5", f"{what} forward", 6,
                       warmup=1)

    def step():
        for t in inputs:
            t.grad = None
        _sq_norm(fn(*inputs)).backward()
    profile_device(step, "5", f"{what} forward+backward", 12, warmup=1)
    for t in inputs:
        t.grad = None
    torch.cuda.empty_cache()


def phase_grad(dev) -> dict:
    """Phase 5: ``loss = sum |y|^2`` through the croft-1024 plans,
    meshless, ``local_impl="pallas"``: the c2c forward (Parseval: x.grad =
    2 N x) and the packed r2c ``forward_filtered`` (h.grad = 2 |s|^2 h,
    x.grad against ``torch.fft.rfftn`` autograd)."""
    import torch
    from repro_torch.core import Croft3D, FFTOptions
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    shape = (FULL,) * 3
    opts = FFTOptions(local_impl="pallas")
    fwd, bwd = {}, {}

    def add(run):
        for into, counts in ((fwd, run["fwd_all"]), (bwd, run["bwd_all"])):
            for name, c in counts.items():
                into[name] = into.get(name, 0) + c

    plan = Croft3D(shape, opts=opts)
    x = torch.randn(*shape, dtype=torch.complex64, device=dev,
                    generator=gen).requires_grad_()
    run = _grad_run(plan.forward, [x], "c2c forward")
    add(run)
    n2 = 2.0 * FULL ** 3
    err = max((x.grad[i:i + 64] - n2 * x.detach()[i:i + 64]).abs().max().item()
              for i in range(0, FULL, 64)) / (n2 * max_abs(x.detach()))
    print(f"[5] c2c x.grad vs 2 N x: max rel err {err:.3e}", flush=True)
    check(err < PARSEVAL_TOL, f"c2c gradient vs Parseval {err}")
    check(run["fwd"].get("fft4step") == 3 and run["bwd"].get("fft4step") == 3,
          f"c2c fft4step launches forward/backward {run['fwd']} {run['bwd']}")
    _profile_step(plan.forward, [x], "c2c")
    del x
    torch.cuda.empty_cache()

    rplan = Croft3D(shape, problem="r2c", strategy="packed", opts=opts)
    xr = torch.randn(*shape, device=dev, generator=gen).requires_grad_()
    h = torch.randn(*rplan.spectrum_shape, dtype=torch.complex64, device=dev,
                    generator=gen).requires_grad_()
    run = _grad_run(rplan.forward_filtered, [xr, h], "r2c forward_filtered")
    add(run)
    gx, gh = xr.grad, h.grad
    xr.grad = h.grad = None
    with torch.no_grad():           # oracles only
        s = torch.fft.rfftn(xr)
        want_h = s.abs().square_().mul_(2) * h
        del s
    h_err = max_abs_diff(gh, want_h) / max_abs(want_h)
    del want_h, gh
    x2 = xr.detach().clone().requires_grad_()
    _sq_norm(torch.fft.rfftn(x2) * h.detach()).backward()
    x_err = max_abs_diff(gx, x2.grad) / max_abs(x2.grad)
    del x2, gx
    torch.cuda.empty_cache()
    print(f"[5] r2c forward_filtered: h.grad vs 2|s|^2 h max rel err "
          f"{h_err:.3e}, x.grad vs torch.fft.rfftn autograd {x_err:.3e}",
          flush=True)
    check(h_err < GRAD_TOL, f"r2c filter gradient {h_err}")
    check(x_err < GRAD_TOL, f"r2c field gradient {x_err}")
    check(run["fwd"].get("unpack_two_for_one", 0) >= 1,
          f"r2c forward unpack launches {run['fwd']}")
    check(run["bwd"].get("spectral_scale_full", 0) >= 2
          and run["bwd"].get("fft4step") == 3,
          f"r2c backward launches {run['bwd']}")
    _profile_step(rplan.forward_filtered, [xr, h], "r2c filtered")
    del xr, h
    torch.cuda.empty_cache()
    print(f"[5] launches per kernel, both cases: forward {fwd}, backward "
          f"{bwd}", flush=True)
    return {n: fwd.get(n, 0) + bwd.get(n, 0) for n in {*fwd, *bwd}}


# ---------------------------------------------------------------------------
# phase 4: h2o-danube-3-4b serving, full width and depth
# ---------------------------------------------------------------------------

def phase_serve(dev) -> dict:
    """Prefill a BATCH x PROMPT prompt and decode GEN greedy tokens on the
    24-layer bf16 model, hold the first decode step against its train
    pass, then the float32 teacher-forcing check at full width and
    TF_LAYERS depth; returns the serving run's launch counts."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import Stage, forward, init_caches, init_params
    from repro_torch.train import (cast_to_compute, greedy_sample,
                                   make_serve_steps)
    from repro_torch.train.data import synth_tokens
    cfg = get_config(ARCH)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats(dev)
    model, t_init = _wall(lambda: cast_to_compute(
        init_params(cfg, gen, dev), cfg.dtype))
    n_params = sum(p.numel() for p in model.parameters())
    weight_gib = sum(p.numel() * p.element_size()
                     for p in model.parameters()) / 2**30
    max_len = PROMPT + GEN
    prefill, decode = make_serve_steps(cfg, BATCH, max_len, kv_block=KV_BLOCK,
                                       device=dev)
    prompts = synth_tokens(SEED, 0, BATCH, PROMPT, cfg.vocab)
    peak_init = torch.cuda.max_memory_allocated(dev) / 2**30
    torch.cuda.reset_peak_memory_stats(dev)
    caches = init_caches(cfg, BATCH, max_len, dtype=torch.bfloat16,
                         device=dev)
    torch.cuda.synchronize()
    reset_launch_counts()
    (logits, caches), t_prefill = _wall(lambda: prefill(model, prompts,
                                                        caches))
    prefill_counts = launch_counts()
    finite = torch.isfinite(logits).all()
    tok = greedy_sample(logits)[:, None]
    out = [tok]
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(GEN - 1):
        logits, caches = decode(model, tok, caches, PROMPT + i)
        if i == 0:
            first_decode = logits
        finite &= torch.isfinite(logits).all()
        tok = greedy_sample(logits)[:, None]
        out.append(tok)
    torch.cuda.synchronize()
    t_decode = (time.perf_counter() - t0) * 1e3
    decode_counts = launch_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    pos = caches[0][0]["self"]["pos"]
    tokens = torch.cat(out, dim=1).cpu()
    print(f"[4] {ARCH} bf16, {cfg.n_layers} layers, {n_params} parameters "
          f"({weight_gib:.2f} GiB): init {t_init:.1f} ms; prefill "
          f"{BATCH}x{PROMPT} {t_prefill:.2f} ms; decode {GEN - 1} steps "
          f"{t_decode:.2f} ms ({BATCH * (GEN - 1) / t_decode * 1e3:.1f} "
          f"tok/s, {t_decode / (GEN - 1):.2f} ms/step); peak {peak_init:.2f} "
          f"GiB at init (fp32 masters), {peak:.2f} GiB serving; "
          f"launches prefill {prefill_counts} decode {decode_counts}; "
          f"tokens {tokens[:, :8].tolist()}", flush=True)
    check(bool(finite), "non-finite logits in phase 4")
    check(prefill_counts.get("flash_attention", 0) == cfg.n_layers,
          f"prefill flash_attention launches {prefill_counts}")
    check(prefill_counts.get(fa.TC, 0) == cfg.n_layers,
          f"prefill launches not all on the tensor cores: {prefill_counts}")
    check(decode_counts.get("flash_attention", 0) == 0,
          f"decode flash_attention launches {decode_counts}")
    window = cfg.stages[0].pattern[0].attn.window
    check(pos.numel() == window and int(pos.max()) == PROMPT + GEN - 2
          and int(pos.min()) == PROMPT + GEN - 1 - window,
          "ring cache positions after the decode")

    # where one prefill's and one decode step's device time goes, by
    # kernel (outside the count); the step's busy time against the mean
    # step wall above is the device's busy share while decoding
    profile_device(lambda: prefill(model, prompts, caches), "4", "prefill", 8)
    profile_device(lambda: decode(model, tok, caches, PROMPT + GEN - 1), "4",
                   "decode step", 4)

    # teacher forcing in bf16 at full depth: the first decode step (plain
    # attention over the ring cache) == the train pass at PROMPT over the
    # prompt and the first greedy token (the kernel on every layer)
    del caches, logits
    torch.cuda.empty_cache()
    seq = torch.cat([torch.as_tensor(prompts, device=dev), out[0]], dim=1)
    reset_launch_counts()
    ref, _ = forward(model, cfg, seq, mode="train", kv_block=KV_BLOCK)
    tf_counts = launch_counts()
    ref = ref[:, PROMPT].float()
    top = ref.abs().max().item()
    err = (first_decode.float() - ref).abs().max().item()
    print(f"[4] teacher forcing bf16, {cfg.n_layers} layers, S={PROMPT}: "
          f"decode vs train max_abs_err {err:.3e} ({err / top:.2e}·max|ref|),"
          f" tol {BF16_TF_TOL * top:.3e}; launches {tf_counts}", flush=True)
    check(err <= BF16_TF_TOL * top, f"bf16 teacher forcing decode err {err}")
    check(tf_counts.get("flash_attention", 0) == cfg.n_layers,
          f"bf16 teacher-forcing flash_attention launches {tf_counts}")
    del model, ref, first_decode
    torch.cuda.empty_cache()

    # teacher forcing in float32 at full width, depth cut to TF_LAYERS:
    # decode at position PROMPT (plain attention over the ring cache) ==
    # the train pass at PROMPT (the kernel over PROMPT + 1 tokens)
    spec = cfg.stages[0].pattern[0]
    cfg32 = dataclasses.replace(cfg, dtype="float32",
                                stages=(Stage((spec,), TF_LAYERS),))
    model = init_params(cfg32, gen, dev)
    tokens = torch.as_tensor(synth_tokens(SEED, 1, BATCH, PROMPT + 1,
                                          cfg.vocab), device=dev)
    reset_launch_counts()
    ref, _ = forward(model, cfg32, tokens, mode="train", kv_block=KV_BLOCK)
    caches = init_caches(cfg32, BATCH, PROMPT + 1, dtype=torch.float32,
                         device=dev)
    pre, caches = forward(model, cfg32, tokens[:, :PROMPT], mode="prefill",
                          caches=caches, kv_block=KV_BLOCK)
    dec, _ = forward(model, cfg32, tokens[:, PROMPT:], mode="decode",
                     caches=caches, start=PROMPT, kv_block=KV_BLOCK)
    tf_counts = launch_counts()
    top = ref.abs().max().item()
    err = (dec[:, 0] - ref[:, PROMPT]).abs().max().item()
    err_pre = (pre - ref[:, :PROMPT]).abs().max().item()
    print(f"[4] teacher forcing f32, {TF_LAYERS} layers, S={PROMPT}: decode "
          f"vs train max_abs_err {err:.3e}, prefill vs train {err_pre:.3e}, "
          f"tol {TF_TOL * top:.3e}; launches {tf_counts}", flush=True)
    check(err <= TF_TOL * top, f"teacher forcing decode err {err}")
    check(err_pre <= TF_TOL * top, f"teacher forcing prefill err {err_pre}")
    check(tf_counts.get("flash_attention", 0) == 2 * TF_LAYERS
          and tf_counts.get(fa.FFMA, 0) == 2 * TF_LAYERS,
          f"teacher-forcing flash_attention launches {tf_counts}")
    del model, caches, ref, pre, dec
    torch.cuda.empty_cache()
    return dict(Counter(prefill_counts) + Counter(decode_counts))


# ---------------------------------------------------------------------------
# ---------------------------------------------------------------------------
# phase 6: the tuner on the card
# ---------------------------------------------------------------------------

TUNE_MESHES = ({"data": 2, "model": 2}, {"data": 2, "model": 4})
TUNE_RACES = (("c2c", 4), ("r2c", 2), ("c2c_grad", 2))
BYTES_TOL = 0.05       # tests/test_roofline.py:136
IMPL_ROWS = 1 << 20    # the local-impl timing shape (2^20, 1024)


def phase_tune_model(dev) -> None:
    """6a: ``mode="model"`` at full width (no execution) on the paper's
    croft-1024 and croft-4096 grids, then one timed call of every local
    1-D FFT implementation at (2^20, 1024), the priors' source."""
    import torch
    from repro_torch.configs.croft_fft import croft_1024, croft_4096
    from repro_torch.core import local_fft
    from repro_torch.tuning import planner
    for cfg in (croft_1024(), croft_4096()):
        for sizes in TUNE_MESHES:
            for problem, _ in TUNE_RACES:
                searches = (("options", "schedule") if problem != "r2c"
                            else ("options",))
                for search in searches:
                    t0 = time.perf_counter()
                    r = planner.tune(cfg.grid, axis_sizes=sizes, mode="model",
                                     problem=problem, search=search,
                                     save=False)
                    host = (time.perf_counter() - t0) * 1e3
                    print(f"[6a] {cfg.name} {sizes} {problem}/{search}: "
                          f"{r.candidate().label}, {r.model_s * 1e6:.1f} us "
                          f"modeled, {len(r.ranked)} candidates, {host:.0f} "
                          "ms host", flush=True)
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    x = torch.randn(IMPL_ROWS, FULL, dtype=torch.complex64, device=dev,
                    generator=gen)
    flops = 5.0 * FULL * math.log2(FULL) * IMPL_ROWS
    for impl in ("pallas", "xla", "matmul", "stockham"):
        t = time_ms(lambda: local_fft.fft_1d(x, -1, -1, impl=impl), reps=3,
                    warmup=1)
        torch.cuda.empty_cache()
        print(f"[6a] local_impl {impl} at ({IMPL_ROWS}, {FULL}): {t:.3f} ms, "
              f"{flops / (t * 1e-3) / 1e12:.2f} TFLOP/s, "
              f"{flops / (t * 1e-3) / FP32_FLOP_S:.4f} of the FP32 peak",
              flush=True)
    del x
    torch.cuda.empty_cache()


def sent_bytes_model(plan) -> float:
    """``comm_bytes_model()`` less the piece a ring or pairwise stage
    keeps: such a stage sends (P-1)/P of its volume, an all-to-all all of
    it (what ``Mesh.counting`` counts)."""
    from repro_torch.core.schedule import stage_transpose_impl
    sched = plan._forward_schedule()
    events = sched.comm_events(plan.shape, plan.mesh.shape,
                               plan.dtype.itemsize)
    kept = sum(ev["bytes"] / ev["comm_size"] for (_, st), ev
               in zip(sched.comm_stages(), events)
               if stage_transpose_impl(st, plan.opts) != "alltoall")
    return plan.comm_bytes_model() - kept


def _race_rows(r, dflt, dflt_model_s: float) -> list:
    """[label, modeled us, measured ms] of every raced candidate; the
    default may lie outside the enumerated space (a packed r2c plan in
    the natural layout), and is then priced here."""
    return [[row["label"], row.get("model_s", dflt_model_s
                                   if row["label"] == dflt.label
                                   else float("nan")) * 1e6,
             row["measured_s"] * 1e3]
            for row in r.ranked if "measured_s" in row]


def worker_tune(rank: int, port: int, wdir: str) -> None:
    """One rank of phases 6b and 6c; prints its results as a JSON line."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from repro_torch import tuning
    from repro_torch.core import Croft3D, make_mesh
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.obs import metrics
    from repro_torch.tuning import cost_model
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    join_ranks(rank, port, RANKS)
    mesh = make_mesh((2, 2), ("data", "model"), device=dev)
    shape = (DIST,) * 3
    wpath = os.path.join(wdir, "wisdom.json")
    res = {"rank": rank, "races": {}, "kernels": {}}

    def agreed(key: str) -> bool:
        keys = [None] * RANKS
        dist.all_gather_object(keys, key)
        return len(set(keys)) == 1

    # 6b: the races, every rank timing its block, the slowest rank's time
    # deciding
    reg = metrics.get_registry()
    winners = {}
    for problem, top_k in TUNE_RACES:
        failures = reg.counter("tune_measure_failures").value
        reset_launch_counts()
        t0 = time.perf_counter()
        r = tuning.tune(shape, mesh, mode="measure", problem=problem,
                        top_k=top_k, wisdom_path=wpath)
        host = time.perf_counter() - t0
        winners[problem] = r
        dflt = tuning.default_candidate(shape, mesh.shape, problem=problem)
        res["races"][problem] = dict(
            winner=r.candidate().label, key=r.key, agreed=agreed(
                r.candidate().plan_key),
            model_us=r.model_s * 1e6, measured_ms=r.measured_s * 1e3,
            default=dflt.label, rows=_race_rows(r, dflt, cost_model.analytic_cost(
                shape, dflt, mesh.shape).total_s), host_s=host,
            launches=launch_counts(),
            dropped=reg.counter("tune_measure_failures").value - failures)

    # the kernels in the tuner's race: measure_candidate on the live mesh
    def timed(tag, cand):
        reset_launch_counts()
        t = tuning.measure_candidate(shape, mesh, cand)
        check(t is not None, f"phase 6b {tag} failed to build or run")
        res["kernels"][tag] = dict(label=cand.label, ms=t * 1e3,
                                   launches=launch_counts())

    def pallas(cand):
        return dataclasses.replace(cand, opts=dataclasses.replace(
            cand.opts, local_impl="pallas"))
    timed("c2c winner, local_impl=pallas", pallas(winners["c2c"].candidate()))
    ranked = cost_model.rank_candidates(
        shape, tuning.enumerate_candidates(shape, mesh.shape), mesh.shape)
    ring = next(c for c, _ in ranked if c.opts.transpose_impl == "ring")
    timed("c2c best ring", ring)
    ranked = cost_model.rank_candidates(
        shape, tuning.enumerate_candidates(shape, mesh.shape, problem="r2c"),
        mesh.shape)
    packed = next(c for c, _ in ranked if c.strategy == "packed")
    timed("r2c best packed, local_impl=pallas", pallas(packed))

    # 6c: the c2c race's wisdom, rebuilt on every rank with no new run
    runs = reg.counter("tune_measure_runs").value
    reset_launch_counts()
    plan = Croft3D(shape, mesh, tune="wisdom", wisdom_path=wpath)
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    x = torch.randn(*shape, dtype=torch.complex64, device=dev, generator=gen)
    ref = torch.fft.fftn(x)        # oracle only
    xl = x[plan.input_sharding].contiguous()
    y, t_fwd = _wall(lambda: plan.forward(xl))
    xb = plan.inverse(y)
    count = cost_model.counted_collectives(plan)
    pred = cost_model.predicted_collectives(plan._forward_schedule(), shape,
                                            mesh.shape, plan.opts)
    hb = torch.randn((2,) + tuple(y.shape), dtype=torch.complex64,
                     device=dev, generator=gen)
    xs = torch.randn((2,) + tuple(xl.shape), dtype=torch.complex64,
                     device=dev, generator=gen)
    yb = plan.forward_filtered_batched(xs, hb)
    ys = torch.stack([plan.forward_filtered(xs[i], hb[i]) for i in range(2)])
    res["wisdom"] = dict(
        source=plan.tune_result.source, plan=plan.candidate().label,
        same=plan.candidate().plan_key
        == winners["c2c"].candidate().plan_key,
        new_runs=reg.counter("tune_measure_runs").value - runs,
        err=(y - ref[plan.output_sharding]).abs().max().item()
        / ref.abs().max().item(),
        rt=(xb - xl).abs().max().item(), fwd_ms=t_fwd,
        counted={k: e["count"] for k, e in count["collectives"].items()
                 if e["count"]},
        predicted={k: n for k, n in pred.items() if n},
        bytes=count["collective_bytes"], model_bytes=plan.comm_bytes_model(),
        sent_bytes=sent_bytes_model(plan), batched_bitwise=bool(torch.equal(yb, ys)),
        batched_diff=(yb - ys).abs().max().item(),
        launches=launch_counts())
    del x, ref, y, xb, hb, xs, yb, ys

    # 6c: the r2c race's wisdom against rfftn, and one gradient of the
    # c2c_grad race's wisdom against Parseval's 2 N x
    runs = reg.counter("tune_measure_runs").value
    reset_launch_counts()
    rplan = Croft3D(shape, mesh, tune="wisdom", problem="r2c",
                    wisdom_path=wpath)
    xr = torch.randn(*shape, device=dev, generator=gen)
    ref = torch.fft.rfftn(xr)      # oracle only
    y = rplan.forward(xr[rplan.input_sharding].contiguous())
    res["wisdom_r2c"] = dict(
        plan=rplan.candidate().label, source=rplan.tune_result.source,
        same=rplan.candidate().plan_key
        == winners["r2c"].candidate().plan_key,
        err=(y - ref[rplan.output_sharding]).abs().max().item()
        / ref.abs().max().item())
    gplan = Croft3D(shape, mesh, tune="wisdom", grad=True, wisdom_path=wpath)
    xg = xl.clone().requires_grad_()
    _sq_norm(gplan.forward(xg)).backward()
    want = 2 * math.prod(shape) * xl
    res["wisdom_grad"] = dict(
        plan=gplan.candidate().label, source=gplan.tune_result.source,
        same=(gplan.decomp, gplan.opts)
        == (winners["c2c_grad"].decomp, winners["c2c_grad"].opts),
        err=(xg.grad - want).abs().max().item() / want.abs().max().item(),
        new_runs=reg.counter("tune_measure_runs").value - runs,
        launches=launch_counts())
    print("RESULT_TUNE " + json.dumps(res), flush=True)
    leave_ranks(mesh)


def phase_tune(dev) -> dict:
    """Phase 6: 6a here, then 6b/6c on 4 gloo ranks of the one card."""
    import tempfile
    t0 = time.time()
    phase_tune_model(dev)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as wdir:
        outs = spawn_ranks("--worker-tune", RANKS, wdir)
    results = _results(outs, "RESULT_TUNE", "6")
    counts = Counter()
    for res in results:
        for race in res["races"].values():
            counts.update(race["launches"])
        for k in res["kernels"].values():
            counts.update(k["launches"])
        counts.update(res["wisdom"]["launches"])
        counts.update(res["wisdom_grad"]["launches"])
    r0 = results[0]
    for problem, race in r0["races"].items():
        check(all(res["races"][problem]["agreed"] for res in results)
              and len({res["races"][problem]["winner"] for res in results})
              == 1, f"phase 6b {problem}: the ranks picked different plans")
        check(all(res["races"][problem]["dropped"] == 0 for res in results),
              f"phase 6b {problem}: a candidate failed to build or run")
        print(f"[6b] {problem} race, {RANKS} ranks at {DIST}^3 (gloo, the "
              f"slowest rank's wall): winner {race['winner']} "
              f"{race['measured_ms']:.2f} ms measured, "
              f"{race['model_us']:.1f} us modeled; default {race['default']};"
              f" tune {race['host_s']:.1f} s host; launches per rank "
              f"{race['launches']}", flush=True)
        for label, model_us, ms in race["rows"]:
            print(f"[6b]   {label:56s} {model_us:10.1f} us modeled "
                  f"{ms:10.2f} ms measured", flush=True)
    for tag, k in r0["kernels"].items():
        print(f"[6b] measure_candidate {tag}: {k['label']} {k['ms']:.2f} ms "
              f"(the c2c winner: {r0['races']['c2c']['measured_ms']:.2f} "
              f"ms); launches per rank {k['launches']}", flush=True)
    check(counts.get("fft4step", 0) > 0, "fft4step not launched in phase 6b")
    check(counts.get("rotate_blocks", 0) > 0,
          "rotate_blocks not launched in phase 6b")
    check(counts.get("unpack_two_for_one", 0) > 0,
          "unpack_two_for_one not launched in phase 6b")
    for res in results:
        w = res["wisdom"]
        check(w["source"] == "wisdom" and w["same"] and w["new_runs"] == 0,
              f"phase 6c rank {res['rank']}: wisdom did not rebuild the plan "
              f"without measuring ({w})")
        check(w["err"] < FFT3_TOL and w["rt"] < RT_TOL,
              f"phase 6c rank {res['rank']}: err {w['err']} rt {w['rt']}")
        check(w["counted"] == w["predicted"],
              f"phase 6c rank {res['rank']}: collectives {w['counted']} != "
              f"predicted {w['predicted']}")
        check(abs(w["bytes"] - w["sent_bytes"])
              <= BYTES_TOL * w["sent_bytes"],
              f"phase 6c rank {res['rank']}: bytes {w['bytes']} vs model "
              f"{w['sent_bytes']} sent of {w['model_bytes']}")
        check(w["batched_bitwise"],
              f"phase 6c rank {res['rank']}: forward_filtered_batched "
              f"differs from two forward_filtered by {w['batched_diff']}")
        wr, wg = res["wisdom_r2c"], res["wisdom_grad"]
        check(wr["source"] == wg["source"] == "wisdom" and wr["same"]
              and wg["same"] and wg["new_runs"] == 0,
              f"phase 6c rank {res['rank']}: the r2c/c2c_grad wisdom did not "
              f"rebuild the races' plans without measuring ({wr}, {wg})")
        check(wr["err"] < RFFT_TOL,
              f"phase 6c rank {res['rank']}: r2c wisdom plan err {wr['err']}")
        check(wg["err"] < PARSEVAL_TOL,
              f"phase 6c rank {res['rank']}: c2c_grad wisdom plan gradient "
              f"err {wg['err']}")
    w = r0["wisdom"]
    print(f"[6c] wisdom plan {w['plan']} on every rank, no new measurement; "
          f"forward {max(r['wisdom']['fwd_ms'] for r in results):.1f} ms, "
          f"rel err {max(r['wisdom']['err'] for r in results):.3e}, round "
          f"trip {max(r['wisdom']['rt'] for r in results):.3e}; collectives "
          f"{w['counted']} = predicted, {w['bytes']:.0f} bytes a rank "
          f"(model {w['sent_bytes']:.0f} sent of {w['model_bytes']:.0f}); "
          f"forward_filtered_batched B=2 bitwise; launches per rank "
          f"{w['launches']}", flush=True)
    wr, wg = r0["wisdom_r2c"], r0["wisdom_grad"]
    print(f"[6c] r2c wisdom plan {wr['plan']}: rel err "
          f"{max(r['wisdom_r2c']['err'] for r in results):.3e} against rfftn;"
          f" c2c_grad wisdom plan {wg['plan']}: gradient rel err "
          f"{max(r['wisdom_grad']['err'] for r in results):.3e} against "
          f"2 N x; launches per rank {wg['launches']}", flush=True)
    check(counts.get("spectral_scale_full", 0) > 0,
          "spectral_scale_full not launched in phase 6c")
    print(f"[6] launches {dict(counts)}; phase 6 {time.time() - t0:.1f} s",
          flush=True)
    return dict(counts)


# ---------------------------------------------------------------------------
# phase 7: the transform service on the card
# ---------------------------------------------------------------------------

SERVE_BATCH = 4        # the service's max_batch in phase 7
SERVE_MIX = 4          # rounds of transforms_main's 3 c2c : 2 r2c : 1 filtered
SERVE_INVERSES = 2     # c2c and r2c inverse requests each (7a)
SERVE_BOUND = 1e-6     # batched vs direct, relative to max|ref| (ROADMAP §3)


def _phase_spans(events: list) -> list:
    """Per-batch (rows, h2d, compute, d2h ms, problem) from the tracer, in
    order."""
    by = {n: [e for e in events if e["name"] == n]
          for n in ("batch:h2d", "batch:compute", "batch:d2h")}
    return [(c["args"]["rows"], a["dur"] / 1e3, c["dur"] / 1e3,
             d["dur"] / 1e3, f"{c['args']['problem']}/"
             f"{c['args']['direction']}")
            for a, c, d in zip(by["batch:h2d"], by["batch:compute"],
                               by["batch:d2h"])]


_STAGING = []


def _to_card(value, device):
    """A host array on ``device``: through the meshless service's pinned
    staging (one for the harness) on the card."""
    import torch
    src = torch.from_numpy(value)
    if device.type != "cuda":
        return src.to(device)
    from repro_torch.serve.service import _Staging
    if not _STAGING:
        _STAGING.append(_Staging())
    got = torch.empty(src.shape, dtype=src.dtype, device=device)
    _STAGING[0].upload(src, got)
    return got


def _to_host(t):
    """The card's tensor as a new host array, through the same staging."""
    from repro_torch.serve.service import _Staging
    if not _STAGING:
        _STAGING.append(_Staging())
    return _STAGING[0].download(t).numpy()


def _served_err(value, want) -> float:
    """max |served - want| / max |want|, on want's device."""
    got = _to_card(value, want.device)
    return ((got - want).abs().max() / want.abs().max()).item()


class _HostMemory:
    """The process's peak resident set over a window, sampled from
    ``/proc/self/statm`` every 10 ms by a thread of its own, and PyTorch's
    pinned host memory (its caching allocator's bytes, peak reset when
    the window opens)."""

    def __enter__(self):
        import threading
        import torch
        if hasattr(torch.cuda, "reset_peak_host_memory_stats"):
            torch.cuda.reset_peak_host_memory_stats()
        self.start = self.peak = self._rss()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    @staticmethod
    def _rss() -> int:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")

    def _sample(self) -> None:
        while not self._stop.wait(0.01):
            self.peak = max(self.peak, self._rss())

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self._rss())

    def report(self) -> str:
        import torch
        stats = getattr(torch.cuda, "host_memory_stats", None)
        pinned = ("not available" if stats is None else
                  {k: v for k, v in stats().items()
                   if "allocated_bytes" in k})
        return (f"RSS {self.start / 2**30:.2f} GiB at the start, peak "
                f"{self.peak / 2**30:.2f} GiB; pinned {pinned}")


def phase_service_local(dev) -> dict:
    """Phase 7a: the meshless service on the card (``TransformService``
    with no mesh: ``Croft3D`` plans with the default options), 512^3,
    ``transforms_main``'s mix plus inverse requests, open loop; then one
    croft-1024 request.  Returns the launch counts of both runs."""
    import torch
    from repro_torch.core import Croft3D
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.obs import tracer as tracer_lib
    from repro_torch.serve import TransformService
    shape = (HALF,) * 3
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    xc = torch.randn(shape, dtype=torch.complex64, device=dev, generator=gen)
    xr = torch.randn(shape, device=dev, generator=gen)
    h = torch.randn(shape, dtype=torch.complex64, device=dev, generator=gen)
    want = {"c2c": torch.fft.fftn(xc), "r2c": torch.fft.rfftn(xr),
            "c2c-inv": xc, "r2c-inv": xr}          # oracles
    want["filtered"] = want["c2c"] * h
    host = {k: _to_host(v) for k, v in (
        ("xc", xc), ("xr", xr), ("h", h), ("yc", want["c2c"]),
        ("yr", want["r2c"]))}
    mix = ([("c2c", host["xc"], {})] * 3
           + [("r2c", host["xr"], {"problem": "r2c"})] * 2
           + [("filtered", host["xc"], {"problem": "filtered",
                                         "h": host["h"]})])
    reqs = (mix * SERVE_MIX
            + [("c2c-inv", host["yc"], {"direction": "inverse"})]
            * SERVE_INVERSES
            + [("r2c-inv", host["yr"], {"problem": "r2c",
                                        "direction": "inverse",
                                        "shape": shape})] * SERVE_INVERSES)
    tol = {"c2c": FFT3_TOL, "filtered": FFT3_TOL, "r2c": RFFT_TOL,
           "c2c-inv": FFT3_TOL, "r2c-inv": RFFT_TOL}
    tracer = tracer_lib.enable()
    start = len(tracer.events())
    reset_launch_counts()
    t0 = time.monotonic()
    with _HostMemory() as mem, TransformService(
            device=dev, max_batch=SERVE_BATCH, max_wait_ms=2.0) as svc:
        futs = [(k, svc.submit(x, **kw)) for k, x, kw in reqs]
        results = [(k, f.result(timeout=TIMEOUT_S)) for k, f in futs]
        stats = svc.stats()
    wall = time.monotonic() - t0
    counts = launch_counts()
    spans = _phase_spans(tracer.events()[start:])
    errs = {}
    for k, r in results:
        check(r.ok, f"phase 7a {k} request failed: {r.error}")
        errs[k] = max(errs.get(k, 0.0), _served_err(r.value, want[k]))
    for k, e in errs.items():
        check(e < tol[k], f"phase 7a {k}: rel err {e} >= {tol[k]}")
    # batched against direct on the same plan (the bound of ROADMAP §3)
    first = max((r for k, r in results if k == "c2c"),
                key=lambda r: r.batch_size)
    direct = Croft3D(shape, device=dev).forward(xc)
    diff = _served_err(first.value, direct)
    bitwise = bool(torch.equal(_to_card(first.value, dev), direct))
    check(diff <= SERVE_BOUND, f"phase 7a batched vs direct {diff}")
    lat = sorted(r.latency_s * 1e3 for _, r in results)
    pct = {p: lat[min(len(lat) - 1, int(p / 100 * len(lat)))]
           for p in (50, 90, 99)}
    print(f"[7a] {len(reqs)} requests at {HALF}^3 (max_batch "
          f"{SERVE_BATCH}, open loop) in {wall:.2f} s: {stats['batches']} "
          f"batches, occupancy {stats['occupancy']:.3f}, batch sizes "
          f"{stats['batch_hist']}; latency ms p50 {pct[50]:.1f} p90 "
          f"{pct[90]:.1f} p99 {pct[99]:.1f} (registry histogram: "
          f"{ {k: round(v, 1) for k, v in stats['latency_ms'].items()} })",
          flush=True)
    print(f"[7a] max rel err vs torch.fft: "
          f"{ {k: f'{e:.3e}' for k, e in errs.items()} }; batched vs "
          f"direct (a batch of {first.batch_size}) {diff:.3e} of max|ref| "
          f"(bitwise {bitwise})", flush=True)
    print(f"[7a] plan cache {json.dumps(stats['plan_cache'])}", flush=True)
    for i, (rows, a, b, c, what) in enumerate(spans):
        print(f"[7a] batch {i} ({what}, {rows} rows): h2d {a:.1f} ms, "
              f"compute {b:.1f} ms, d2h {c:.1f} ms", flush=True)
    print(f"[7a] the service's {wall * 1e3:.0f} ms: h2d "
          f"{sum(x[1] for x in spans):.0f}, compute "
          f"{sum(x[2] for x in spans):.0f}, d2h "
          f"{sum(x[3] for x in spans):.0f} ms in the batch spans",
          flush=True)
    print(f"[7a] launches {counts}", flush=True)
    print(f"[7a] host memory: {mem.report()}; of it the payloads "
          f"{sum(a.nbytes for a in host.values()) / 2**30:.2f} GiB and the "
          f"results {sum(r.value.nbytes for _, r in results) / 2**30:.2f} "
          f"GiB", flush=True)
    check(counts.get("spectral_scale_full", 0) > 0,
          "spectral_scale_full not launched in phase 7a")
    del xc, xr, h, want, host, mix, reqs, futs, results, direct, first
    torch.cuda.empty_cache()

    # one croft-1024 request at batch 1 (8 GiB in, 8 GiB out)
    big = (FULL,) * 3
    x = torch.randn(big, dtype=torch.complex64, device=dev, generator=gen)
    payload = _to_host(x)
    ref = torch.fft.fftn(x)                           # oracle only
    del x
    torch.cuda.empty_cache()
    start = len(tracer.events())
    reset_launch_counts()
    with _HostMemory() as mem, TransformService(device=dev,
                                                max_batch=1) as svc:
        r = svc.submit(payload).result(timeout=TIMEOUT_S)
    big_counts = launch_counts()
    (_, h2d, comp, d2h, _), = _phase_spans(tracer.events()[start:])
    tracer_lib.disable()
    check(r.ok, f"phase 7a {FULL}^3 request failed: {r.error}")
    del payload
    err = _served_err(r.value, ref)
    check(err < FFT3_TOL, f"phase 7a {FULL}^3: rel err {err}")
    print(f"[7a] one {FULL}^3 c2c request: latency "
          f"{r.latency_s * 1e3:.1f} ms (h2d {h2d:.1f}, compute {comp:.1f}, "
          f"d2h {d2h:.1f}), rel err {err:.3e}, launches {big_counts}; "
          f"host memory: {mem.report()} (payload and result 8 GiB each)",
          flush=True)
    del r, ref
    torch.cuda.empty_cache()
    return dict(Counter(counts) + Counter(big_counts))


def worker_service(rank: int, port: int, wdir: str) -> None:
    """One rank of phase 7b: the SPMD service on a pencil 2x2 mesh at
    256^3, rank 0 the front end; prints its result as a JSON line."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.core import Croft3D, Decomposition, FFTOptions, make_mesh
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.obs import tracer as tracer_lib
    from repro_torch.resil import FaultSpec, injection
    from repro_torch.serve import PlanCache, TransformService
    from repro_torch.tuning import wisdom as wisdom_lib
    from repro_torch.tuning.candidates import Candidate
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    join_ranks(rank, port, RANKS)
    mesh = make_mesh((2, 2), ("y", "z"), device=dev)
    shape = (DIST,) * 3
    lead = rank == 0
    wpath = os.path.join(wdir, "wisdom.json")
    cache = PlanCache(mesh, wisdom_path=wpath, max_plans=2, measure_after=3,
                      quarantine_after=1,
                      tune_kw=dict(top_k=2, measure_iters=2))
    ckey = cache.key_for(shape, np.complex64, "c2c")
    rkey = cache.key_for(shape, np.complex64, "r2c")
    pencil = Decomposition("pencil", ("y", "z"))
    if lead:
        # the plans a user imports as wisdom: a ring c2c plan with the
        # Hopper FFT kernel (a model pick: cold, so it gets measured) and a
        # packed r2c plan with the kernels (measured: it stays)
        ring = Candidate(pencil, FFTOptions(transpose_impl="ring",
                                            local_impl="pallas"))
        packed = Candidate(pencil, FFTOptions(local_impl="pallas"),
                           problem="r2c", strategy="packed")
        wisdom_lib.merge_entries(wpath, {
            ckey: wisdom_lib.WisdomEntry.from_candidate(ring, "model"),
            rkey: wisdom_lib.WisdomEntry.from_candidate(
                packed, "measure", measured_s=1.0)})
    dist.barrier()
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    xc = torch.randn(shape, dtype=torch.complex64, device=dev, generator=gen)
    xr = torch.randn(shape, device=dev, generator=gen)
    h = torch.randn(shape, dtype=torch.complex64, device=dev, generator=gen)
    res = {"rank": rank}
    served = None
    svc = TransformService(mesh, max_batch=SERVE_BATCH, max_wait_ms=50.0,
                           cache=cache, registry=cache.registry)
    tracer = tracer_lib.enable()
    reset_launch_counts()
    t0 = time.monotonic()
    with svc:
        if lead:
            want = {"c2c": torch.fft.fftn(xc), "r2c": torch.fft.rfftn(xr)}
            want["filtered"] = want["c2c"] * h
            hc, hr, hh = (v.cpu().numpy() for v in (xc, xr, h))
            yr = want["r2c"].cpu().numpy()
            futs = [("c2c", svc.submit(hc)) for _ in range(3)]   # 3 -> 4
            futs += [("r2c", svc.submit(hr, problem="r2c")) for _ in range(2)]
            futs += [("filtered", svc.submit(hc, problem="filtered", h=hh)),
                     ("r2c-inv", svc.submit(yr, problem="r2c",
                                            direction="inverse",
                                            shape=shape))]
            first = [(k, f.result(timeout=TIMEOUT_S)) for k, f in futs]
            # hits 3 and on: the measured upgrade, on every rank
            after = [svc.submit(hc).result(timeout=TIMEOUT_S)
                     for _ in range(3)]
            evict = svc.submit(hc[:DIST // 2, :DIST // 2, :DIST // 2]
                               ).result(timeout=TIMEOUT_S)
            with injection([FaultSpec("exec.output", kind="nan")]):
                poisoned = svc.submit(hc).result(timeout=TIMEOUT_S)
            degraded = svc.submit(hc).result(timeout=TIMEOUT_S)
            want["r2c-inv"], want["c2c-upgraded"] = xr, want["c2c"]
            errs = {}
            for k, r in first + [("c2c-upgraded", r) for r in after]:
                check(r.ok, f"phase 7b {k} request failed: {r.error}")
                errs[k] = max(errs.get(k, 0.0), _served_err(r.value, want[k]))
            snap = svc.registry.snapshot()
            res.update(
                errs=errs, batch=[first[0][1].batch_size,
                                  first[0][1].padded_size],
                states=[r.plan_state for r in after], evict_ok=evict.ok,
                poisoned=[poisoned.ok, poisoned.error],
                degraded_err=_served_err(degraded.value, want["c2c"]),
                counters={k: snap[k]["value"] for k in (
                    "serve_nan_outputs", "plan_quarantines",
                    "plan_degradations", "serve_requests", "serve_batches")})
            served = degraded.value
            del want
    res["seconds"] = time.monotonic() - t0
    res["launches"] = launch_counts()
    res["spans"] = _phase_spans(tracer.events())
    tracer_lib.disable()
    cp = cache._plans[ckey]
    res.update(upgrades=cache.stats.upgrades, evictions=cache.stats.evictions,
               size=len(cache), rung=cp.rung, quarantined=cp.quarantined,
               plan=cp.plan.candidate().label)
    if lead:
        blob = json.load(open(wpath))
        res["wisdom"] = dict(source=blob["entries"][ckey]["source"],
                             lock=os.path.exists(wpath + ".lock"))
    # the degraded results against a direct call of the fallback plan
    box = [served]
    dist.broadcast_object_list(box, src=0)
    with torch.no_grad():
        y = cp.plan.forward(xc[cp.plan.input_sharding].contiguous())
    res["degraded_bitwise"] = bool(np.array_equal(
        box[0][cp.plan.output_sharding], y.cpu().numpy()))
    # the batching gate: B = 4 counts B = 1's collectives and 4x the bytes
    tuned = Croft3D(shape, mesh, tune="wisdom", wisdom_path=wpath)
    packed = Croft3D(shape, mesh, pencil, FFTOptions(local_impl="pallas"),
                     problem="r2c", strategy="packed")
    res["gate"] = {}
    for name, plan in (("c2c tuned", tuned), ("r2c packed", packed)):
        rows = []
        for b in (1, SERVE_BATCH):
            x = torch.zeros((b,) + plan.local_input_shape(),
                            dtype=plan.input_dtype, device=dev)
            with torch.no_grad(), mesh.counting() as c:
                plan.forward_batched(x)
            rows.append(({k: e["count"] for k, e in c.collectives.items()},
                         c.bytes))
        res["gate"][name] = dict(plan=plan.candidate().label, b1=rows[0],
                                 b4=rows[1])
    print("RESULT_SERVICE " + json.dumps(res), flush=True)
    svc.close()
    leave_ranks(mesh)


def phase_service_ranks() -> dict:
    """Phase 7b: the SPMD service on 4 gloo ranks of the one card."""
    import tempfile
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as wdir:
        outs = spawn_ranks("--worker-service", RANKS, wdir)
    results = _results(outs, "RESULT_SERVICE", "7b")
    r0 = results[0]
    counts = Counter()
    for res in results:
        counts.update(res["launches"])
    for k, e in r0["errs"].items():
        tol = RFFT_TOL if k.startswith("r2c") else FFT3_TOL
        check(e < tol, f"phase 7b {k}: rel err {e} >= {tol}")
    check(r0["batch"] == [3, SERVE_BATCH],
          f"phase 7b: the ragged batch ran as {r0['batch']}")
    check(r0["states"][-1] == "warm"
          and all(r["upgrades"] == 1 for r in results),
          f"phase 7b: no cold -> warm upgrade on every rank "
          f"({r0['states']}, {[r['upgrades'] for r in results]})")
    check(r0["wisdom"] == {"source": "measure", "lock": False},
          f"phase 7b: the measured plan is not in wisdom ({r0['wisdom']})")
    check(r0["evict_ok"] and all(r["evictions"] >= 1 and r["size"] == 2
                                 for r in results),
          "phase 7b: no LRU eviction at max_plans=2 on every rank")
    check(not r0["poisoned"][0] and "non-finite" in r0["poisoned"][1]
          and r0["counters"]["serve_nan_outputs"] == 1
          and r0["counters"]["plan_quarantines"] == 1
          and r0["counters"]["plan_degradations"] == 1,
          f"phase 7b: exec.output did not quarantine ({r0['poisoned']}, "
          f"{r0['counters']})")
    check(len({(r["rung"], r["plan"]) for r in results}) == 1
          and r0["rung"] != "primary" and all(r["quarantined"]
                                              for r in results),
          f"phase 7b: the ranks degraded differently "
          f"{[(r['rung'], r['plan']) for r in results]}")
    check(all(r["degraded_bitwise"] for r in results)
          and r0["degraded_err"] < FFT3_TOL,
          "phase 7b: degraded results differ from the fallback plan")
    for name, g in r0["gate"].items():
        for res in results:
            (c1, b1), (c4, b4) = res["gate"][name]["b1"], res["gate"][name]["b4"]
            check(c1 == c4 and sum(c1.values()) > 0 and b4 == SERVE_BATCH * b1,
                  f"phase 7b batching gate {name} rank {res['rank']}: "
                  f"B=1 {c1} {b1} bytes, B={SERVE_BATCH} {c4} {b4} bytes")
        print(f"[7b] batching gate {name} ({g['plan']}): B=1 {g['b1'][0]} "
              f"{g['b1'][1]} bytes a rank, B={SERVE_BATCH} {g['b4'][0]} "
              f"{g['b4'][1]} bytes", flush=True)
    for name in ("fft4step", "rotate_blocks", "unpack_two_for_one",
                 "hermitian_extend", "spectral_scale_full"):
        check(counts.get(name, 0) > 0, f"{name} not launched in phase 7b")
    print(f"[7b] {RANKS} ranks at {DIST}^3 (gloo): {r0['seconds']:.1f} s of "
          f"service; rel err {r0['errs']}; upgrade states {r0['states']}; "
          f"quarantined to {r0['rung']} ({r0['plan']}) on every rank, "
          f"degraded results bitwise the fallback plan's; counters "
          f"{r0['counters']}", flush=True)
    for i, (rows, a, b, c, what) in enumerate(r0["spans"]):
        print(f"[7b] batch {i} ({what}, {rows} rows; rank 0, gloo): "
              f"scatter+h2d {a:.1f} ms, compute {b:.1f} ms, d2h+gather "
              f"{c:.1f} ms", flush=True)
    print(f"[7b] launches {dict(counts)}", flush=True)
    return dict(counts)


def phase_service(dev) -> dict:
    """Phase 7: 7a then 7b; returns the launches of both."""
    t0 = time.time()
    local = phase_service_local(dev)
    t1 = time.time()
    counts = Counter(local) + Counter(phase_service_ranks())
    print(f"[7] launches {dict(counts)}; phase 7 {time.time() - t0:.1f} s "
          f"(7a {t1 - t0:.1f}, 7b {time.time() - t1:.1f})", flush=True)
    return dict(counts)


# ---------------------------------------------------------------------------
# phase 8: per-stage overlap attribution on 4 gloo ranks of the one card
# ---------------------------------------------------------------------------

TRACE_ITERS = 3        # timed runs of every stage, leg and round
TRACE_N = 64           # the meshless service run's grid (5 ragged requests)
SERVE_SPANS = ("request:submit", "request:queue", "batch:dispatch",
               "batch:compute", "batch:d2h")   # benchmarks/trace_smoke.py
SEQ_SHAPE = (2, 4096, 1024)  # phase 9b's (B, S, D): fnet-350m's width
SEQ_TOL = 2e-4         # tests/test_parallel.py:126
FNET = "fnet-350m"     # src/repro/configs/fnet_350m.py
FNET_BATCH = 2         # prefill_32k's batch 32, cut for time and memory
FNET_SEQ = 32768       # prefill_32k's sequence (src/repro/configs/shapes.py)


def worker_trace(rank: int, port: int, wdir: str) -> None:
    """One rank of phase 8, then of 9b: ``trace_forward`` of the two
    acceptance plans (``pallas``) and a model-tuned plan at 256^3 on a
    pencil 2x2 mesh under one tracer, each output against
    ``plan.forward``; rank 0 then drives a short meshless service run
    under the same tracer and saves the trace.  Then the FNet mixer's
    sequence FFT over the mesh against the local mixer.  Prints its
    result as a JSON line."""
    import torch
    from repro_torch.core import Croft3D, Decomposition, FFTOptions, make_mesh
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.spectral import spectral_mixer
    from repro_torch.obs import instrument
    from repro_torch.obs import tracer as tracer_lib
    from repro_torch.serve import TransformService
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    join_ranks(rank, port, RANKS)
    mesh = make_mesh((2, 2), ("y", "z"), device=dev)
    shape = (DIST,) * 3
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    x = torch.randn(shape, dtype=torch.complex64, device=dev, generator=gen)
    pencil = Decomposition("pencil", ("y", "z"))
    plans = [(label, Croft3D(shape, mesh, pencil, FFTOptions(
        overlap_k=k, transpose_impl=impl, output_layout="spectral",
        local_impl="pallas")))
        for label, impl, k in (("alltoall-k2", "alltoall", 2),
                               ("ring-k1", "ring", 1))]
    plans.append(("tuned-256", Croft3D.tuned(shape, mesh, mode="model")))
    res = {"rank": rank, "plans": {}}
    tracer = tracer_lib.enable()
    reset_launch_counts()
    t0 = time.monotonic()
    for label, plan in plans:
        xl = x[plan.input_sharding].contiguous()
        y, summary = instrument.trace_forward(plan, xl, tracer=tracer,
                                              iters=TRACE_ITERS, label=label)
        with torch.no_grad():
            want = plan.forward(xl)
        res["plans"][label] = dict(
            summary=summary, n_stages=len(plan._forward_schedule().stages),
            err=((y - want).abs().max() / want.abs().max()).item())
    res["trace_s"] = time.monotonic() - t0
    res["launches"] = launch_counts()
    res["host_staged_bytes"] = mesh.host_staged_bytes
    if rank == 0:
        g = torch.Generator().manual_seed(SEED)
        payloads = [torch.randn((TRACE_N,) * 3, dtype=torch.complex64,
                                generator=g).numpy() for _ in range(5)]
        with TransformService(device=dev, max_batch=SERVE_BATCH,
                              max_wait_ms=2.0) as svc:
            futs = [svc.submit(p) for p in payloads]
            got = [f.result(timeout=TIMEOUT_S) for f in futs]
        check(all(r.ok for r in got), "phase 8 service run failed: "
              + str([r.error for r in got if not r.ok]))
        res["served"] = [r.batch_size for r in got]
        tracer.save(os.path.join(wdir, "trace.json"))
    tracer_lib.disable()

    # 9b: the FNet sequence FFT over the mesh (batch over y, sequence over
    # z, as tests/test_parallel.py:116-126) against the local mixer
    b, s, d = SEQ_SHAPE
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    xs = torch.randn(SEQ_SHAPE, device=dev, generator=gen)
    ref = spectral_mixer(xs)
    c = mesh.coords
    bl, sl = b // 2, s // 2
    blk = (slice(bl * c["y"], bl * (c["y"] + 1)),
           slice(sl * c["z"], sl * (c["z"] + 1)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = spectral_mixer(xs[blk].contiguous(), seq_axis_name="z", mesh=mesh,
                         batch_spec="y")
    torch.cuda.synchronize()
    res["seq_ms"] = (time.perf_counter() - t0) * 1e3
    res["seq_err"] = ((got - ref[blk]).abs().max() / ref.abs().max()).item()
    res["seq_shape"] = list(got.shape)
    print("RESULT_TRACE " + json.dumps(res, default=str), flush=True)
    leave_ranks(mesh)


def validate_trace(doc: dict, expected: dict) -> list:
    """The trace smoke's checks (``benchmarks/trace_smoke.py:_validate``):
    the schema of every event, one distinct per-stage span per schedule
    stage of each traced plan, the service's lifecycle spans, and an
    overlap efficiency for both acceptance plans; returns the failures."""
    from repro_torch.obs import CATEGORIES
    fails = []
    events = doc.get("traceEvents")
    if not isinstance(events, list) or not events:
        return ["traceEvents missing or empty"]
    for ev in events:
        if ev.get("ph") not in ("X", "i"):
            fails.append(f"bad ph in {ev}")
        elif not isinstance(ev.get("name"), str) or not ev["name"]:
            fails.append(f"bad name in {ev}")
        elif ev.get("cat") not in CATEGORIES:
            fails.append(f"unknown category {ev.get('cat')!r}")
        elif not isinstance(ev.get("ts"), (int, float)) or ev["ts"] < 0:
            fails.append(f"bad ts in {ev['name']}")
        elif "pid" not in ev or "tid" not in ev:
            fails.append(f"missing pid/tid in {ev['name']}")
        elif ev["ph"] == "X" and ev.get("dur", -1) < 0:
            fails.append(f"bad dur in {ev['name']}")
        if fails:
            break  # one schema failure is enough signal
    for label, n_stages in expected.items():
        got = {ev["args"].get("stage") for ev in events
               if ev.get("ph") == "X"
               and ev.get("args", {}).get("part") == "stage"
               and ev.get("args", {}).get("plan") == label}
        if len(got) != n_stages:
            fails.append(f"{label}: {len(got)} stage spans, schedule has "
                         f"{n_stages} stages")
    names = {ev["name"] for ev in events}
    for need in SERVE_SPANS:
        if need not in names:
            fails.append(f"serve lifecycle span {need!r} missing")
    plans = {s.get("plan"): s for s in
             (doc.get("metadata") or {}).get("attribution") or []}
    for label in ("alltoall-k2", "ring-k1"):
        overall = (plans.get(label) or {}).get("overall") or {}
        if not isinstance(overall.get("efficiency"), float):
            fails.append(f"{label}: no overlap-efficiency in attribution")
    return fails


def phase_trace() -> tuple[dict, list]:
    """Phase 8 (and 9b in the same ranks); returns phase 8's launches
    and the ranks' results."""
    import shutil
    import tempfile
    from repro_torch.obs import report
    t0 = time.time()
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as wdir:
        outs = spawn_ranks("--worker-trace", RANKS, wdir)
        path = os.path.join(ROOT, "build", "phase8_trace.json")
        shutil.copyfile(os.path.join(wdir, "trace.json"), path)
    results = _results(outs, "RESULT_TRACE", "8")
    counts = Counter()
    for res in results:
        counts.update(res["launches"])
    r0 = results[0]
    for label, got in r0["plans"].items():
        s = got["summary"]
        check(all(r["plans"][label]["err"] < FFT3_TOL for r in results),
              f"phase 8 {label}: trace_forward output vs plan.forward "
              f"{[r['plans'][label]['err'] for r in results]}")
        check(all(json.dumps(r["plans"][label]["summary"], sort_keys=True)
                  == json.dumps(s, sort_keys=True) for r in results),
              f"phase 8 {label}: the ranks' summaries differ")
        check(len(s["stages"]) == got["n_stages"],
              f"phase 8 {label}: {len(s['stages'])} rows, "
              f"{got['n_stages']} stages")
        for row in s["stages"]:
            if row["comm_s"] > 0 and s["transpose_impl"] in ("ring",
                                                             "pairwise"):
                # every axis of the 2x2 mesh has P = 2: round 1 alone
                check([r["round"] for r in row.get("rounds", [])] == [1],
                      f"phase 8 {label} {row['name']}: rounds "
                      f"{row.get('rounds')}")
        if label in ("alltoall-k2", "ring-k1"):
            eff = (s["overall"] or {}).get("efficiency")
            check(eff is not None and 0.0 <= eff <= 1.0,
                  f"phase 8 {label}: overlap efficiency {eff}")
    with open(path) as f:
        doc = json.load(f)
    expected = {label: got["n_stages"] for label, got in r0["plans"].items()}
    fails = validate_trace(doc, expected)
    check(not fails, "phase 8 trace validation: " + "; ".join(fails))
    print(f"[8] {RANKS} ranks, {DIST}^3, gloo on one card: per-stage "
          f"attribution (slowest rank's medians of {TRACE_ITERS}; C and the "
          "efficiency are gloo's and the host's)", flush=True)
    check(report.main([path]) == 0, "repro_torch.obs.report failed")
    for label, got in r0["plans"].items():
        for row in got["summary"]["stages"]:
            m = row["model"] or {}
            print(f"[8] {label} {row['name']}: wall {row['wall_s'] * 1e3:.3f}"
                  f" ms, F {row['fft_s'] * 1e3:.3f}, C "
                  f"{row['comm_s'] * 1e3:.3f}, hidden "
                  f"{row['hidden_s'] * 1e3:.3f} ms, eff "
                  f"{row['measured_efficiency']}; model compute "
                  f"{m.get('compute_s')}, collective {m.get('collective_s')},"
                  f" eff {m.get('predicted_efficiency')}; rounds "
                  f"{[round(r['wall_s'] * 1e3, 3) for r in row.get('rounds', [])]}"
                  f" ms; counted {row['hlo']}", flush=True)
        print(f"[8] {label} ({got['summary']['plan_key']}): e2e "
              f"{got['summary']['e2e_s'] * 1e3:.3f} ms, overall "
              f"{got['summary']['overall']}, max err vs forward "
              f"{max(r['plans'][label]['err'] for r in results):.3e}",
              flush=True)
    print(f"[8] trace {path}: {len(doc['traceEvents'])} events, service "
          f"batches {r0['served']}; traced in {r0['trace_s']:.1f} s; "
          f"host-staged bytes a rank {r0['host_staged_bytes']}; launches "
          f"{dict(counts)}; phase 8+9b {time.time() - t0:.1f} s", flush=True)
    for name in ("fft4step", "rotate_blocks"):
        check(counts.get(name, 0) > 0, f"{name} not launched in phase 8")
    return dict(counts), results


# ---------------------------------------------------------------------------
# phase 9: the FNet spectral mixer, fnet-350m at full width and depth
# ---------------------------------------------------------------------------

def phase_fnet(dev, trace_results: list) -> dict:
    """9a: the fnet-350m encoder forward (24 layers, bf16, seeded weights)
    at prefill_32k's sequence and batch 2: wall, device time by kernel,
    peak memory, finite logits; 9b (run by phase 8's ranks): the
    distributed sequence FFT against the local mixer; 9c: the mixer
    served, ``examples/serve_lm_torch.py`` for 4 users.  Returns the
    launch counts of 9a and 9c."""
    import importlib.util
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import forward, init_params
    from repro_torch.train import cast_to_compute
    from repro_torch.train.data import synth_tokens
    t_phase = time.time()
    cfg = get_config(FNET)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model, t_init = _wall(lambda: cast_to_compute(
        init_params(cfg, gen, dev), cfg.dtype))
    n_params = sum(p.numel() for p in model.parameters())
    weight_gib = sum(p.numel() * p.element_size()
                     for p in model.parameters()) / 2**30
    tokens = torch.from_numpy(synth_tokens(
        SEED, 0, FNET_BATCH, FNET_SEQ, cfg.vocab)).to(dev)

    def run():
        return forward(model, cfg, tokens, mode="train")[0]
    logits, t_cold = _wall(run)
    del logits
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev) / 2**30
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    logits, t_warm = _wall(run)
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    check(tuple(logits.shape) == (FNET_BATCH, FNET_SEQ, cfg.vocab)
          and logits.dtype == torch.bfloat16,
          f"phase 9a logits {tuple(logits.shape)} {logits.dtype}")
    finite = bool(torch.isfinite(logits).all())
    check(finite, "phase 9a: non-finite logits")
    scale = max_abs(logits[0], step=4096)
    del logits
    torch.cuda.empty_cache()
    print(f"[9a] {FNET} bf16, {cfg.n_layers} layers, {n_params} parameters "
          f"({weight_gib:.2f} GiB), B {FNET_BATCH} x S {FNET_SEQ}: init "
          f"{t_init:.0f} ms, forward {t_cold:.1f} ms cold, {t_warm:.1f} ms "
          f"warm (host clock to a synchronize); peak {peak:.2f} GiB over "
          f"{base:.2f} GiB resident; logits finite, max|logit| {scale:.3f}; "
          f"launches {counts}", flush=True)
    busy, _ = profile_device(lambda: run(), "9a", "encoder forward", 12)
    print(f"[9a] device busy {busy:.1f} ms of a {t_warm:.1f} ms forward",
          flush=True)

    r0 = trace_results[0]
    err = max(r["seq_err"] for r in trace_results)
    check(all(r["seq_shape"] == [SEQ_SHAPE[0] // 2, SEQ_SHAPE[1] // 2,
                                 SEQ_SHAPE[2]] for r in trace_results),
          f"phase 9b block shapes {[r['seq_shape'] for r in trace_results]}")
    check(err < SEQ_TOL, f"phase 9b: distributed mixer vs local {err}")
    print(f"[9b] distributed_seq_fft at (B, S, D) = {SEQ_SHAPE} on {RANKS} "
          f"gloo ranks (batch over y, sequence over z) vs spectral_mixer: "
          f"max rel err {err:.3e} (tol {SEQ_TOL}); "
          f"{max(r['seq_ms'] for r in trace_results):.1f} ms (slowest rank, "
          f"host clock, gloo)", flush=True)

    spec = importlib.util.spec_from_file_location(
        "serve_lm_torch", os.path.join(ROOT, "examples", "serve_lm_torch.py"))
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    reset_launch_counts()
    t0 = time.perf_counter()
    got = example.serve_users(users=4, layers=2, seq=SEQ_SHAPE[1],
                              dmodel=SEQ_SHAPE[2], device=dev, seed=SEED)
    t_serve = time.perf_counter() - t0
    served = launch_counts()
    counts = dict(Counter(counts) + Counter(served))
    stats = got["stats"]
    check(got["worst"] < 1e-2 * max(got["scale"], 1.0),
          f"phase 9c: served vs direct {got['worst']} (scale {got['scale']})")
    print(f"[9c] 4 users x 2 mixer layers ({SEQ_SHAPE[1]}x{SEQ_SHAPE[2]}) "
          f"served on {got['device']}: max|served - direct| "
          f"{got['worst']:.3e} (scale {got['scale']:.1f}); "
          f"{stats['requests']} requests in {stats['batches']} batches, "
          f"latency {stats['latency_ms']}; {t_serve:.1f} s; launches "
          f"{served}", flush=True)
    print(f"[9] phase 9 {time.time() - t_phase:.1f} s (9b in phase 8's "
          f"ranks)", flush=True)
    return counts


# ---------------------------------------------------------------------------
# phase 10: MLA, the latent cache and the MoE FFN
# ---------------------------------------------------------------------------

DS = "deepseek-v2-236b"   # src/repro/configs/deepseek_v2_236b.py
DS_MOE_LAYERS = 3         # MoE layers after the dense layer 0 (cut from 59)
DS_PROMPT = 4096          # 10a's prompt (the model has full attention)
DS_TF_SEQ = 1024          # 10a's float32 teacher-forcing sequence
MX = "mixtral-8x22b"      # src/repro/configs/mixtral_8x22b.py
MX_LAYERS = 4             # cut from 56
MX_PROMPT = 6144          # past the model's 4096-token window
# teacher forcing holds only where no (token, choice) pair is dropped: a
# decode step routes 2 tokens and never drops, while at the configs' own
# factor 1.25 a train pass over the seeded weights drops most pairs (the
# hidden states share a direction that the random routers all favour).
# The checks run the same weights at capacity factor 16
# (tests/test_models_smoke.py:68-77), or E/top_k where that already makes
# the capacity the token count, and read the dropped pairs: none
TF_CAPACITY = 16.0
EP_TOKENS = 256           # 10c's tokens a rank
EP_TOL = 1e-5             # tests/test_perf_paths.py:64 (x max|ref| here)


def _moe_cut(arch: str, moe_layers: int, capacity_factor=None,
             dtype=None):
    """``arch``'s config at full width with ``moe_layers`` MoE layers (after
    deepseek's dense layer 0), optionally at another capacity factor and
    compute dtype."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import Stage
    cfg = get_config(arch)
    stages = list(cfg.stages)
    spec = stages[-1].pattern[0]
    if capacity_factor is not None:
        spec = dataclasses.replace(spec, moe=dataclasses.replace(
            spec.moe, capacity_factor=capacity_factor))
    stages[-1] = Stage((spec,), moe_layers)
    return dataclasses.replace(cfg, stages=tuple(stages),
                               dtype=dtype or cfg.dtype)


def _tf_capacity(arch: str) -> float:
    """The teacher-forcing checks' capacity factor (see TF_CAPACITY)."""
    m = _moe_cut(arch, 1).stages[-1].pattern[0].moe
    return min(TF_CAPACITY, m.n_experts / m.top_k)


class _DroppedPairs:
    """Reads each ``moe_fwd`` inside the scope by wrapping ``moe._dispatch``:
    the (token, choice) pairs it drops at capacity, its most-loaded
    expert's pairs over the mean load, and the mean cosine of its hidden
    states to their mean direction (all stay on the card until read).
    ``check_calls`` fails unless the wrapper saw the expected number of
    dispatches, so that a run that stopped reaching it checks nothing."""

    def __enter__(self):
        import torch
        from repro_torch.models import moe as moe_lib
        self._lib, self._inner = moe_lib, moe_lib._dispatch
        self.sums, self.load, self.cos = [], [], []

        def dispatch(xt, router, m, cap):
            buf, meta = self._inner(xt, router, m, cap)
            keep, slot = meta[0], meta[1]
            self.sums.append((~keep).sum())
            hits = torch.bincount(slot // cap, minlength=m.n_experts)
            self.load.append(hits.max() * m.n_experts / slot.numel())
            u = torch.nn.functional.normalize(xt.float(), dim=-1)
            self.cos.append(
                (u @ torch.nn.functional.normalize(u.mean(0), dim=0)).mean())
            return buf, meta
        moe_lib._dispatch = dispatch
        return self

    def __exit__(self, *exc):
        self._lib._dispatch = self._inner

    def check_calls(self, want: int, tag: str) -> None:
        check(len(self.sums) == want, f"phase {tag}: {len(self.sums)} MoE "
              f"dispatches seen, {want} expected")

    def per_layer(self) -> list:
        return [int(t) for t in self.sums]

    def skew(self) -> str:
        return (f"most-loaded expert / mean load "
                f"{[round(float(t), 2) for t in self.load]}, mean cosine of "
                f"the hidden states to their mean "
                f"{[round(float(t), 3) for t in self.cos]}")


class _FirstAttention:
    """Keeps a copy of the first ``flash_attention`` call of each distinct
    signature (q and k shapes, dtype, options) that the attention layers
    make inside the scope, and counts the calls, by wrapping the name
    ``models.attention`` calls.  whisper's prefill has two: the encoder's
    non-causal self-attention over the frames and the decoder's causal
    one over the prompt."""

    def __enter__(self):
        from repro_torch.models import attention
        self._lib, self._inner = attention, attention.flash_attention
        self.calls, self.firsts = 0, {}

        def flash_attention(q, k, v, **kw):
            key = (tuple(q.shape), tuple(k.shape), q.dtype,
                   tuple(sorted(kw.items())))
            if key not in self.firsts:
                self.firsts[key] = ((q.clone(), k.clone(), v.clone()), kw)
            self.calls += 1
            return self._inner(q, k, v, **kw)
        attention.flash_attention = flash_attention
        return self

    def __exit__(self, *exc):
        self._lib.flash_attention = self._inner

    def check_firsts(self, tag: str, expect: int | None = None) -> None:
        """The wrapper on each captured call's inputs against the plain
        version, element by element (``attention_err``), on the wgmma
        variant; with ``expect``, there must be that many signatures."""
        import torch
        from repro_torch.kernels import flash_attention as fa
        check(expect is None or len(self.firsts) == expect,
              f"phase {tag}: flash_attention call signatures "
              f"{list(self.firsts)}, {expect} expected")
        for (q, k, v), kw in self.firsts.values():
            got = fa.flash_attention(q, k, v, **kw)
            want = fa.flash_attention_plain(q, k, v, **kw)
            err, share = attention_err(got, want)
            print(f"[{tag}] flash_attention on the first prefill call at "
                  f"{tuple(q.shape)} kv={tuple(k.shape)} {kw}: max_abs_err "
                  f"{err:.3e}, worst err/tol {share:.3f}", flush=True)
            check(share <= 1.0 and bool(torch.isfinite(got).all()),
                  f"phase {tag}: flash_attention on the prefill's inputs "
                  f"{tuple(q.shape)} {kw}")
            check(fa.variant(q, k, v) == fa.TC,
                  f"phase {tag}: the prefill's inputs {tuple(q.shape)} are "
                  f"not on wgmma")
            del got, want
        self.firsts = {}


def _serve_moe(dev, tag: str, arch: str, layers: int, prompt: int) -> tuple:
    """Prefill a BATCH x ``prompt`` prompt and decode GEN greedy tokens on
    ``arch`` cut to ``layers`` MoE layers (bf16, seeded weights, the
    config's capacity), profile one prefill and one decode step; then, on
    the same weights at the teacher-forcing capacity, a prefill and the
    first decode step held against the bf16 train pass over the prompt
    and its first token.  Returns the launches of the served prefill, of
    its decode steps and of the teacher-forcing runs, and the attention
    layer's ``flash_attention`` calls in the served prefill (the first of
    each signature held against the plain version on its own inputs)."""
    import gc
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import forward, init_caches, init_params
    from repro_torch.train import (cast_to_compute, greedy_sample,
                                   make_serve_steps)
    from repro_torch.train.data import synth_tokens
    cfg = _moe_cut(arch, layers)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats(dev)
    model, t_init = _wall(lambda: cast_to_compute(
        init_params(cfg, gen, dev), cfg.dtype))
    n_params = sum(p.numel() for p in model.parameters())
    weight_gib = sum(p.numel() * p.element_size()
                     for p in model.parameters()) / 2**30
    peak_init = torch.cuda.max_memory_allocated(dev) / 2**30
    max_len = prompt + GEN
    prefill, decode = make_serve_steps(cfg, BATCH, max_len, kv_block=KV_BLOCK,
                                       device=dev)
    prompts = synth_tokens(SEED, 0, BATCH, prompt, cfg.vocab)
    torch.cuda.reset_peak_memory_stats(dev)
    caches = init_caches(cfg, BATCH, max_len, dtype=torch.bfloat16,
                         device=dev)
    reset_launch_counts()
    with _DroppedPairs() as dropped, _FirstAttention() as attn:
        (logits, caches), t_prefill = _wall(lambda: prefill(model, prompts,
                                                            caches))
    prefill_counts = launch_counts()
    dropped.check_calls(layers, tag)
    attn.check_firsts(tag)
    finite = torch.isfinite(logits).all()
    tok = greedy_sample(logits)[:, None]
    out = [tok]
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(GEN - 1):
        logits, caches = decode(model, tok, caches, prompt + i)
        finite &= torch.isfinite(logits).all()
        tok = greedy_sample(logits)[:, None]
        out.append(tok)
    torch.cuda.synchronize()
    t_decode = (time.perf_counter() - t0) * 1e3
    decode_counts = launch_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    tokens = torch.cat(out, dim=1).cpu()
    m = cfg.stages[-1].pattern[0].moe
    print(f"[{tag}] {cfg.name} bf16, {cfg.n_layers} layers, {n_params} "
          f"parameters ({weight_gib:.2f} GiB): init {t_init:.1f} ms, peak "
          f"{peak_init:.2f} GiB (fp32 masters); prefill {BATCH}x{prompt} "
          f"{t_prefill:.2f} ms (first call); decode {GEN - 1} steps "
          f"{t_decode:.2f} ms ({t_decode / (GEN - 1):.2f} ms/step, "
          f"{BATCH * (GEN - 1) / t_decode * 1e3:.1f} tok/s); peak "
          f"{peak:.2f} GiB serving; pairs dropped per MoE layer of the "
          f"prefill at capacity factor {m.capacity_factor} "
          f"{dropped.per_layer()} of {BATCH * prompt * m.top_k} ("
          f"{dropped.skew()}); launches "
          f"prefill {prefill_counts} decode {decode_counts}; tokens "
          f"{tokens[:, :8].tolist()}", flush=True)
    check(bool(finite), f"non-finite logits in phase {tag}")
    profile_device(lambda: prefill(model, prompts, caches), tag, "prefill",
                   10)
    profile_device(lambda: decode(model, tok, caches, prompt + GEN - 1), tag,
                   "decode step", 8)
    del caches, logits
    gc.collect()
    torch.cuda.empty_cache()

    # teacher forcing in bf16, same weights, no pair dropped: the first
    # decode step == the train pass at ``prompt`` over the prompt and the
    # first greedy token
    tf_cfg = _moe_cut(arch, layers, _tf_capacity(arch))
    prefill, decode = make_serve_steps(tf_cfg, BATCH, prompt + 1,
                                       kv_block=KV_BLOCK, device=dev)
    caches = init_caches(tf_cfg, BATCH, prompt + 1, dtype=torch.bfloat16,
                         device=dev)
    seq = torch.cat([torch.as_tensor(prompts, device=dev), out[0]], dim=1)
    reset_launch_counts()
    with _DroppedPairs() as dropped:
        _, caches = prefill(model, prompts, caches)
        first_decode, _ = decode(model, out[0], caches, prompt)
        del caches
        ref, _ = forward(model, tf_cfg, seq, mode="train", kv_block=KV_BLOCK)
    tf_counts = launch_counts()
    dropped.check_calls(3 * layers, tag)
    ref = ref[:, prompt].float()
    top = ref.abs().max().item()
    err = (first_decode.float() - ref).abs().max().item()
    lost = sum(dropped.per_layer())
    print(f"[{tag}] teacher forcing bf16, {cfg.n_layers} layers, S={prompt}, "
          f"capacity factor {_tf_capacity(arch):.4g}: decode vs train "
          f"max_abs_err {err:.3e} ({err / top:.2e}·max|ref|), tol "
          f"{BF16_TF_TOL * top:.3e}; pairs dropped (prefill, decode, train) "
          f"{lost}; launches {tf_counts}", flush=True)
    check(lost == 0, f"phase {tag}: teacher forcing dropped {lost} pairs")
    check(err <= BF16_TF_TOL * top,
          f"phase {tag}: bf16 teacher forcing decode err {err}")
    del model, ref, first_decode
    gc.collect()
    torch.cuda.empty_cache()
    return prefill_counts, decode_counts, tf_counts, attn.calls


def _teacher_forcing_f32(dev, tag: str, cfg, seq: int) -> None:
    """Float32 teacher forcing: the decode logits at ``seq`` and the
    prefill's against the train pass over seq + 1 tokens, 2e-4 of
    max|ref|."""
    import gc
    import torch
    from repro_torch.models import forward, init_caches, init_params
    from repro_torch.train.data import synth_tokens
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                        dev)
    tokens = torch.as_tensor(synth_tokens(SEED, 1, BATCH, seq + 1, cfg.vocab),
                             device=dev)
    with _DroppedPairs() as dropped:
        ref, _ = forward(model, cfg, tokens, mode="train", kv_block=KV_BLOCK)
        caches = init_caches(cfg, BATCH, seq + 1, dtype=torch.float32,
                             device=dev)
        pre, caches = forward(model, cfg, tokens[:, :seq], mode="prefill",
                              caches=caches, kv_block=KV_BLOCK)
        dec, _ = forward(model, cfg, tokens[:, seq:], mode="decode",
                         caches=caches, start=seq, kv_block=KV_BLOCK)
    dropped.check_calls(3 * cfg.stages[-1].n_layers, tag)
    lost = sum(dropped.per_layer())
    top = ref.abs().max().item()
    err = (dec[:, 0] - ref[:, seq]).abs().max().item()
    err_pre = (pre - ref[:, :seq]).abs().max().item()
    factor = cfg.stages[-1].pattern[0].moe.capacity_factor
    print(f"[{tag}] teacher forcing f32, {cfg.n_layers} layers (capacity "
          f"factor {factor:.4g}), S={seq}: decode vs train max_abs_err "
          f"{err:.3e}, prefill vs train {err_pre:.3e}, tol "
          f"{TF_TOL * top:.3e}; pairs dropped {lost}", flush=True)
    check(lost == 0, f"phase {tag}: teacher forcing dropped {lost} pairs")
    check(err <= TF_TOL * top, f"phase {tag}: f32 teacher forcing decode "
          f"err {err}")
    check(err_pre <= TF_TOL * top, f"phase {tag}: f32 teacher forcing "
          f"prefill err {err_pre}")
    del model, caches, ref, pre, dec
    gc.collect()
    torch.cuda.empty_cache()


def worker_moe(rank: int, port: int) -> None:
    """One rank of 10c: the "ep" dispatch at deepseek's expert widths on a
    (data 1, model 4) mesh, against rank 0's meshless ``moe_fwd`` over all
    ranks' tokens.  Each rank draws the full MoE from the seed in turn
    (one full float32 copy on the card at a time) and keeps its block.
    Prints its result as a JSON line, then runs 11f's scans on the same
    mesh (``scan_check``) and prints theirs."""
    import gc
    import torch
    import torch.distributed as dist
    from repro_torch.core import make_mesh
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.moe import init_moe, moe_fwd
    from repro_torch.models.moe_sharded import (moe_fwd_sharded, moe_mode,
                                                shard_moe)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    join_ranks(rank, port, RANKS)
    mesh = make_mesh((1, RANKS), ("data", "model"), device=dev)
    cfg = _moe_cut(DS, 1, TF_CAPACITY)
    m, d = cfg.stages[-1].pattern[0].moe, cfg.d_model
    x = torch.randn(1, RANKS * EP_TOKENS, d, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(SEED))
    ref = torch.empty(x.shape, dtype=torch.float32)
    for r in range(RANKS):
        if r == rank:
            full = init_moe(d, m, torch.Generator(device=dev).manual_seed(
                SEED + 10), dev)
            if rank == 0:
                ref = moe_fwd(full, x, m).cpu()
            local = shard_moe(full, m, mesh, cp_axis="model",
                              tp_axis="model")
            del full
            gc.collect()
            torch.cuda.empty_cache()
        dist.barrier()
    dist.broadcast(ref, 0)
    rows = slice(rank * EP_TOKENS, (rank + 1) * EP_TOKENS)
    xl = x[:, rows].contiguous()

    def run():
        return moe_fwd_sharded(local, xl, m, mesh=mesh, cp_axis="model",
                               tp_axis="model", overlap_k=2)
    run()                                   # warm-up
    dist.barrier()
    reset_launch_counts()
    with mesh.counting() as cnt:
        got, ms = _wall(run)
    launches = launch_counts()
    err = (got.cpu() - ref[:, rows]).abs().max().item()
    print("RESULT_MOE " + json.dumps(dict(
        mode=moe_mode(m, mesh, "model", "model"), shape=list(got.shape),
        w_gate=list(local.w_gate.shape), err=err,
        top=ref.abs().max().item(), ms=ms, collectives=cnt.collectives,
        launches=launches,
        peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30)), flush=True)
    del local, x, xl, ref, got
    gc.collect()
    torch.cuda.empty_cache()
    print("RESULT_SCAN " + json.dumps(scan_check(rank, mesh, dev)),
          flush=True)
    leave_ranks(mesh)


def phase_moe(dev) -> tuple:
    """10a deepseek-v2-236b, 10b mixtral-8x22b, 10c the ep dispatch (whose
    ranks then run 11f's scans); returns the serving runs' launch counts
    and each rank's 11f result."""
    import dataclasses
    import gc
    import torch
    from repro_torch.kernels import flash_attention as fa
    t_phase = time.time()
    gc.collect()
    torch.cuda.empty_cache()
    counts = Counter()

    pre, dec, tf, calls = _serve_moe(dev, "10a", DS, DS_MOE_LAYERS,
                                     DS_PROMPT)
    counts.update(pre)
    counts.update(dec)
    check(not pre and not dec and not tf and not calls,
          f"phase 10a: MLA launched a kernel {pre} {dec} {tf} {calls}")
    _teacher_forcing_f32(dev, "10a", _moe_cut(DS, 1, _tf_capacity(DS),
                                               "float32"), DS_TF_SEQ)
    print(f"[10a] {time.time() - t_phase:.1f} s", flush=True)

    t0 = time.time()
    pre, dec, tf, calls = _serve_moe(dev, "10b", MX, MX_LAYERS, MX_PROMPT)
    counts.update(pre)
    counts.update(dec)
    check(calls == MX_LAYERS, f"phase 10b: {calls} flash_attention calls "
          f"from the attention layer in the prefill, {MX_LAYERS} expected")
    check(pre.get("flash_attention", 0) == MX_LAYERS
          and pre.get(fa.TC, 0) == MX_LAYERS,
          f"phase 10b prefill flash_attention launches {pre}")
    check(dec.get("flash_attention", 0) == 0,
          f"phase 10b decode flash_attention launches {dec}")
    check(tf.get("flash_attention", 0) == 2 * MX_LAYERS
          and tf.get(fa.TC, 0) == 2 * MX_LAYERS,
          f"phase 10b teacher-forcing flash_attention launches {tf}")
    print(f"[10b] {time.time() - t0:.1f} s", flush=True)

    t0 = time.time()
    outs = spawn_ranks("--worker-moe", RANKS)
    results = _results(outs, "RESULT_MOE", "10c")
    top = results[0]["top"]
    cfg = _moe_cut(DS, 1)
    m = cfg.stages[-1].pattern[0].moe
    for r, res in enumerate(results):
        check(res["mode"] == "ep"
              and res["shape"] == [1, EP_TOKENS, cfg.d_model]
              and res["w_gate"] == [m.n_experts // RANKS, cfg.d_model,
                                    m.d_ff_expert],
              f"phase 10c rank {r}: {res}")
        check(res["err"] <= EP_TOL * top,
              f"phase 10c rank {r}: ep dispatch vs moe_fwd {res['err']}")
    print(f"[10c] ep dispatch, {RANKS} gloo ranks, (data 1, model "
          f"{RANKS}), deepseek expert widths, {EP_TOKENS} tokens a rank, "
          f"float32: max_abs_err {max(r['err'] for r in results):.3e} "
          f"(tol {EP_TOL * top:.3e}); {max(r['ms'] for r in results):.1f} "
          f"ms (slowest rank, host clock, gloo); collectives a rank "
          f"{results[0]['collectives']}; launches "
          f"{[r['launches'] for r in results]}; peak GiB a rank "
          f"{[round(r['peak_gib'], 2) for r in results]}; "
          f"{time.time() - t0:.1f} s", flush=True)
    print(f"[10] phase 10 {time.time() - t_phase:.1f} s", flush=True)
    return dict(counts), _results(outs, "RESULT_SCAN", "11f")


# ---------------------------------------------------------------------------
# phase 11: head_dim-256 attention off the kernel, the dense configs and
# the recurrent layers
# ---------------------------------------------------------------------------

P11_PROMPT = 4096         # past gemma3's and recurrentgemma's windows
GEMMA = "gemma3-4b"       # src/repro/configs/gemma3_4b.py
YI9 = "yi-9b"             # src/repro/configs/yi_9b.py
YI34 = "yi-34b"           # src/repro/configs/yi_34b.py
YI34_LAYERS = 16          # cut from 60: 34.4e9 fp32 masters are 137 GB
RG = "recurrentgemma-9b"  # src/repro/configs/recurrentgemma_9b.py
RWKV = "rwkv6-3b"         # src/repro/configs/rwkv6_3b.py
GQA_SEQ = 1024            # 11a's (2, 1024) segment, 8 heads over 4
GQA_D = 2560              # 11a's model width (gemma3-4b's)
STEP_TOKENS = 256         # decode vs prefill on one mixer: tokens
RG_STEP_TOL = 3e-5        # tests/test_layers.py:259-262
RWKV_STEP_TOL = 3e-4      # tests/test_layers.py:276-279
REC_TF_SEQ = 1024         # the float32 teacher-forcing sequence
# rwkv6-3b's teacher-forcing depth, float32 and bf16.  With depth the
# seeded RWKV-6 stack amplifies bf16 rounding past 5e-2 of max|ref| in
# the reference too (tests/test_torch_lm_archs.py::
# test_rwkv_bf16_teacher_forcing_drifts_with_depth_in_the_reference_too),
# so bf16 is held at this depth and read at 32
RWKV_TF_LAYERS = 2
SCAN_VEC = (2, 4096, 4096)        # 11f: cp_vector_recurrence's (B, T, D)
SCAN_MAT = (2, 4096, 40, 64)      # 11f: cp_matrix_recurrence's (B, T, H, K)
SCAN_VEC_TOL = 1e-5       # tests/test_parallel.py:44-45
SCAN_MAT_TOL = 1e-4       # tests/test_parallel.py:58-59


def phase_gqa_head_dims(dev) -> None:
    """11a: ``gqa_fwd`` over a segment at 0 at head_dim 256 and 128 (8
    heads over 4, 2 x GQA_SEQ, window GQA_SEQ and none), float32 and bf16
    on the card, against the same call on the CPU in float32 on the same
    (bf16-representable) values: no kernel launch at 256, one at 128
    (``wgmma`` for bf16, FFMA for float32).  Float32 within ATTN_TOL,
    bf16 within ATTN_BF16_REL·max|want| + ATTN_TOL (the layer rounds its
    projections to bf16 around the core)."""
    import copy
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import launch_counts
    from repro_torch.models.attention import MaskSpec, gqa_fwd, init_gqa
    from repro_torch.models.config import AttentionSpec
    for head_dim in (256, 128):
        for window in (GQA_SEQ, None):
            a = AttentionSpec(kind="gqa", n_heads=8, n_kv_heads=4,
                              head_dim=head_dim, window=window)
            p = init_gqa(GQA_D, a, torch.Generator().manual_seed(SEED),
                         "cpu")
            for w in p.parameters():
                w.data = w.data.bfloat16().float()
            x = torch.randn(BATCH, GQA_SEQ, GQA_D, generator=torch.Generator(
                ).manual_seed(SEED + 1)).bfloat16().float()
            pos = torch.arange(GQA_SEQ, dtype=torch.int32)
            ms = MaskSpec(causal=True, window=window)
            want, _ = gqa_fwd(p, x, a, ms, pos, start=0)
            top = want.abs().max().item()
            for dtype in (torch.float32, torch.bfloat16):
                pd = copy.deepcopy(p).to(dev, dtype)
                before = launch_counts()
                got, _ = gqa_fwd(pd, x.to(dev, dtype), a, ms, pos.to(dev),
                                 start=0)
                torch.cuda.synchronize()
                after = launch_counts()
                launched = {k: n - before.get(k, 0) for k, n in after.items()
                            if n != before.get(k, 0)}
                err = (got.float().cpu() - want).abs().max().item()
                tol = ATTN_TOL if dtype == torch.float32 \
                    else ATTN_BF16_REL * top + ATTN_TOL
                name = str(dtype).split(".")[-1]
                print(f"[11a] gqa_fwd head_dim {head_dim} window {window} "
                      f"{name}: max_abs_err vs the CPU float32 {err:.3e} "
                      f"(tol {tol:.3e}, max|want| {top:.3f}); launches "
                      f"{launched}", flush=True)
                check(err <= tol and bool(torch.isfinite(got).all()),
                      f"phase 11a head_dim {head_dim} {name}: err {err}")
                if head_dim > fa.D_MAX:
                    check(not launched, f"phase 11a head_dim {head_dim}: "
                          f"launched {launched}")
                else:
                    variant = fa.TC if dtype == torch.bfloat16 else fa.FFMA
                    check(launched.get(fa.NAME) == 1
                          and launched.get(variant) == 1,
                          f"phase 11a head_dim {head_dim} {name}: launched "
                          f"{launched}")
                del pd, got


def _cut(arch: str, layers=None, dtype=None):
    """``arch``'s config at full width, its depth cut to ``layers`` of its
    first pattern (one stage), optionally in another dtype."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import Stage
    cfg = get_config(arch)
    if layers is not None:
        pattern = cfg.stages[0].pattern
        if layers % len(pattern):
            raise ValueError(f"{layers} layers do not hold whole "
                             f"{len(pattern)}-layer groups")
        cfg = dataclasses.replace(
            cfg, stages=(Stage(pattern, layers // len(pattern)),))
    return dataclasses.replace(cfg, dtype=dtype or cfg.dtype)


def _frontend(cfg, stub) -> tuple:
    """``make_serve_steps``' prefill keywords for ``stub`` (an
    encoder-decoder's frames, a prefix-LM's prefix embeddings), the
    prefix's length and the cross caches' ``enc_len``."""
    if stub is None:
        return {}, 0, 0
    if cfg.encoder is not None:
        return {"frames": stub}, 0, stub.shape[1]
    return {"prefix_embeds": stub}, stub.shape[1], 0


def _forward_inputs(model, cfg, stub) -> dict:
    """``forward``'s keywords for ``stub`` in train and prefill mode: the
    encoder memory of the frames, or the prefix embeddings."""
    from repro_torch.models import encode
    if stub is None:
        return {}
    if cfg.encoder is not None:
        return {"enc_out": encode(model, cfg, stub, KV_BLOCK)}
    return {"prefix_embeds": stub}


def _tf_bf16(dev, tag: str, model, cfg, prompts, first, hold: bool,
             stub=None) -> dict:
    """Teacher forcing in bf16: the first decode step after a fresh
    prefill of ``prompts`` (after ``stub``'s frames or prefix, when
    given) == the train pass over the prompt and the token ``first``,
    within BF16_TF_TOL of max|ref| when ``hold`` (else a reading only);
    the train pass's logits cover the token positions only.  Returns the
    launches."""
    import gc
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import forward, init_caches
    from repro_torch.train import make_serve_steps
    batch, prompt = prompts.shape
    frontend, prefix, enc_len = _frontend(cfg, stub)
    max_len = prefix + prompt + 1
    prefill, decode = make_serve_steps(cfg, batch, max_len,
                                       kv_block=KV_BLOCK, device=dev)
    caches = init_caches(cfg, batch, max_len, enc_len=enc_len,
                         dtype=torch.bfloat16, device=dev)
    seq = torch.cat([torch.as_tensor(prompts, device=dev), first], dim=1)
    reset_launch_counts()
    _, caches = prefill(model, prompts, caches, **frontend)
    first_decode, _ = decode(model, first, caches, prefix + prompt)
    del caches
    ref, _ = forward(model, cfg, seq, mode="train", kv_block=KV_BLOCK,
                     **_forward_inputs(model, cfg, stub))
    counts = launch_counts()
    check(ref.shape[:2] == seq.shape, f"phase {tag}: train logits "
          f"{tuple(ref.shape)} for {tuple(seq.shape)} tokens after "
          f"{prefix} prefix positions")
    ref = ref[:, prompt].float()
    top = ref.abs().max().item()
    err = (first_decode.float() - ref).abs().max().item()
    after = f" after {prefix} prefix positions" if prefix else ""
    print(f"[{tag}] teacher forcing bf16, {cfg.n_layers} layers, "
          f"S={prompt}{after}, logits over {seq.shape[1]} token positions: "
          f"decode vs train max_abs_err {err:.3e} ({err / top:.2e}·max|ref|), tol {BF16_TF_TOL * top:.3e}"
          f"{'' if hold else ' (a reading, not held: see PERF.md §6)'}; "
          f"launches {counts}", flush=True)
    if hold:
        check(err <= BF16_TF_TOL * top,
              f"phase {tag}: bf16 teacher forcing decode err {err}")
    del ref, first_decode
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def _check_cross_cache(tag: str, model, cfg, enc, caches) -> None:
    """Layer 0's cross cache after the prefill against ``gqa_project_kv``
    of the encoder memory ``enc``, within CROSS_TOL of max|ref|."""
    import torch
    from repro_torch.models.attention import gqa_project_kv
    from repro_torch.models.model import _cross_spec
    layer = model.stages[0][0]
    pos = torch.arange(enc.shape[1], dtype=torch.int32, device=enc.device)
    want = gqa_project_kv(layer.cross, enc, _cross_spec(
        cfg.stages[0].pattern[0].attn), pos)
    got = caches[0][0]["cross"]
    for name, w in zip(("k", "v"), want):
        top = w.float().abs().max().item()
        err = (got[name].float() - w.float()).abs().max().item()
        print(f"[{tag}] layer 0's cross cache {name} {tuple(w.shape)} vs "
              f"gqa_project_kv of the encoder memory: max_abs_err {err:.3e} "
              f"(tol {CROSS_TOL * top:.3e})", flush=True)
        check(err <= CROSS_TOL * top, f"phase {tag}: cross cache {name} "
              f"err {err}")


def _decode_read_bytes(model, caches, batch: int,
                       n_pos: int) -> tuple[int, int]:
    """The bytes one decode step must read, as (weights, caches).  The
    weights: the decoder's stages and final norm, and the head (the tied
    table whole, or an untied head and the ``batch`` rows of the input
    table it looks up); an encoder's weights serve only the prefill.  The
    caches: every cross and recurrent tensor, and the slots of each self
    cache that hold one of the ``n_pos`` positions written so far."""
    def nbytes(tensors) -> int:
        return sum(t.numel() * t.element_size() for t in tensors)
    e = model.embed
    weights = (nbytes(model.stages.parameters())
               + nbytes(model.final_norm.parameters()))
    if e.head is None:
        weights += nbytes([e.tok])
    else:
        weights += (nbytes([e.head])
                    + batch * e.tok.shape[1] * e.tok.element_size())
    cache = 0
    for layers in caches:
        for layer in layers:
            for kind, part in layer.items():
                for name, t in part.items():
                    if kind == "self" and name != "pos":
                        cache += (nbytes([t]) * min(t.shape[1], n_pos)
                                  // t.shape[1])
                    else:
                        cache += nbytes([t])
    return weights, cache


def _serve_lm(dev, tag: str, cfg, prompt: int, tf_layers=None,
              batch: int = BATCH, stub=None) -> tuple:
    """Prefill a ``batch`` x ``prompt`` prompt (after ``stub``: an
    encoder-decoder's frames, which the prefill encodes, or a prefix-LM's
    prefix embeddings) and decode GEN greedy tokens (bf16, seeded
    weights), profile one prefill and one decode step (its busy time
    against the bytes it must read, ``_decode_read_bytes``, over the
    memory rate; the step sits at the last position, so every self-cache
    position is written), then the bf16 teacher forcing (``_tf_bf16``):
    held at full depth, or, with ``tf_layers``, read at full depth and
    held on the same config cut to ``tf_layers`` layers.  An
    encoder-decoder's ``encode`` is timed alone first, and layer 0's
    cross cache after the prefill is held against ``gqa_project_kv`` of
    the encoder memory.  Returns the launches of the served prefill, of
    its decode steps and of the full-depth teacher forcing, and the
    attention layers' ``flash_attention`` calls in the served prefill
    (the first of each signature held against the plain version on its
    inputs)."""
    import dataclasses
    import gc
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import Stage, encode, init_caches, init_params
    from repro_torch.train import (cast_to_compute, greedy_sample,
                                   make_serve_steps)
    from repro_torch.train.data import synth_tokens
    gen = torch.Generator(device=dev).manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats(dev)
    model, t_init = _wall(lambda: cast_to_compute(
        init_params(cfg, gen, dev), cfg.dtype))
    n_params = sum(p.numel() for p in model.parameters())
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    peak_init = torch.cuda.max_memory_allocated(dev) / 2**30
    frontend, prefix, enc_len = _frontend(cfg, stub)
    max_len = prefix + prompt + GEN
    prefill, decode = make_serve_steps(cfg, batch, max_len, kv_block=KV_BLOCK,
                                       device=dev)
    prompts = synth_tokens(SEED, 0, batch, prompt, cfg.vocab)
    torch.cuda.reset_peak_memory_stats(dev)
    caches = init_caches(cfg, batch, max_len, enc_len=enc_len,
                         dtype=torch.bfloat16, device=dev)
    if cfg.encoder is not None:
        _, t_cold = _wall(lambda: encode(model, cfg, stub, KV_BLOCK))
        enc, t_warm = _wall(lambda: encode(model, cfg, stub, KV_BLOCK))
        print(f"[{tag}] encode {tuple(stub.shape)}: {t_cold:.2f} ms (first "
              f"call), {t_warm:.2f} ms (second)", flush=True)
    reset_launch_counts()
    with _FirstAttention() as attn:
        (logits, caches), t_prefill = _wall(lambda: prefill(
            model, prompts, caches, **frontend))
    prefill_counts = launch_counts()
    # an encoder-decoder's prefill: the encoder's non-causal calls over the
    # frames and the decoder's causal ones over the prompt
    attn.check_firsts(tag, expect=2 if cfg.encoder is not None else None)
    if cfg.encoder is not None:
        _check_cross_cache(tag, model, cfg, enc, caches)
        del enc
    finite = torch.isfinite(logits).all()
    tok = greedy_sample(logits)[:, None]
    out = [tok]
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(GEN - 1):
        logits, caches = decode(model, tok, caches, prefix + prompt + i)
        finite &= torch.isfinite(logits).all()
        tok = greedy_sample(logits)[:, None]
        out.append(tok)
    torch.cuda.synchronize()
    t_decode = (time.perf_counter() - t0) * 1e3
    decode_counts = launch_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    tokens = torch.cat(out, dim=1).cpu()
    print(f"[{tag}] {cfg.name} bf16, {cfg.n_layers} layers, {n_params} "
          f"parameters ({weight_bytes / 2**30:.2f} GiB): init {t_init:.1f} "
          f"ms, peak {peak_init:.2f} GiB (fp32 masters); prefill "
          f"{batch}x{prompt} after {prefix} prefix positions "
          f"{t_prefill:.2f} ms (first call); decode "
          f"{GEN - 1} steps {t_decode:.2f} ms ({t_decode / (GEN - 1):.2f} "
          f"ms/step, {batch * (GEN - 1) / t_decode * 1e3:.1f} tok/s); peak "
          f"{peak:.2f} GiB serving; flash_attention calls in the prefill "
          f"{attn.calls}; launches prefill {prefill_counts} decode "
          f"{decode_counts}; tokens {tokens[:, :8].tolist()}", flush=True)
    check(bool(finite), f"non-finite logits in phase {tag}")
    profile_device(lambda: prefill(model, prompts, caches, **frontend), tag,
                   "prefill", 10)
    busy, _ = profile_device(
        lambda: decode(model, tok, caches, prefix + prompt + GEN - 1), tag,
        "decode step", 8)
    read_w, read_c = _decode_read_bytes(model, caches, batch, max_len)
    bound = (read_w + read_c) / HBM_BYTES_S * 1e3
    print(f"[{tag}] decode step busy {busy:.3f} ms against the bytes bound "
          f"{bound:.3f} ms (weights it reads {read_w / 1e9:.4f} GB + caches "
          f"{read_c / 1e9:.4f} GB over {HBM_BYTES_S / 1e12:.2f} TB/s; "
          f"{bound / busy * 100:.1f} %)", flush=True)
    del caches, logits
    gc.collect()
    torch.cuda.empty_cache()

    tf_counts = _tf_bf16(dev, tag, model, cfg, prompts, out[0],
                         hold=tf_layers is None, stub=stub)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    if tf_layers is not None:
        pattern = cfg.stages[0].pattern
        small = dataclasses.replace(cfg, stages=(
            Stage(pattern, tf_layers // len(pattern)),))
        model = cast_to_compute(init_params(small, gen, dev), small.dtype)
        _tf_bf16(dev, tag, model, small, prompts, out[0], hold=True,
                 stub=stub)
        del model
        gc.collect()
        torch.cuda.empty_cache()
    return prefill_counts, decode_counts, tf_counts, attn.calls


def _tf_f32(dev, tag: str, cfg, seq: int, stub=None) -> dict:
    """Float32 teacher forcing, 2e-4 of max|ref|: the decode logits at
    ``seq`` against the train pass over seq + 1 tokens, and the prefill's
    against the train pass over the same ``seq`` tokens, each after
    ``stub`` (frames to encode, or prefix embeddings) when given.  The prefill
    against the first ``seq`` positions of the longer pass is printed as
    a reading, with its worst positions: the two passes' GEMMs differ in
    shape, so their rounding differs, and RWKV-6's per-head RMS norm
    (eps 1e-6) magnifies that where a head's output nearly cancels, as
    at the first positions (PERF.md §6).  Returns the launches."""
    import gc
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import forward, init_caches, init_params
    from repro_torch.train.data import synth_tokens
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                        dev)
    tokens = torch.as_tensor(synth_tokens(SEED, 1, BATCH, seq + 1, cfg.vocab),
                             device=dev)
    _, prefix, enc_len = _frontend(cfg, stub)
    reset_launch_counts()
    kw = _forward_inputs(model, cfg, stub)
    ref, _ = forward(model, cfg, tokens, mode="train", kv_block=KV_BLOCK,
                     **kw)
    ref_seq, _ = forward(model, cfg, tokens[:, :seq], mode="train",
                         kv_block=KV_BLOCK, **kw)
    caches = init_caches(cfg, BATCH, prefix + seq + 1, enc_len=enc_len,
                         dtype=torch.float32, device=dev)
    pre, caches = forward(model, cfg, tokens[:, :seq], mode="prefill",
                          caches=caches, kv_block=KV_BLOCK, **kw)
    dec, _ = forward(model, cfg, tokens[:, seq:], mode="decode",
                     caches=caches, start=prefix + seq, kv_block=KV_BLOCK)
    counts = launch_counts()
    top = ref.abs().max().item()
    err = (dec[:, 0] - ref[:, seq]).abs().max().item()
    err_pre = (pre - ref_seq).abs().max().item()
    by_pos = (pre - ref[:, :seq]).abs().amax(dim=(0, 2))
    worst = by_pos.topk(3)
    worst_errs = [f"{v:.2e}" for v in worst.values.tolist()]
    print(f"[{tag}] teacher forcing f32, {cfg.n_layers} layers, S={seq} "
          f"after {prefix} prefix positions: "
          f"decode vs train max_abs_err {err:.3e}, prefill vs train over "
          f"the same tokens {err_pre:.3e}, tol {TF_TOL * top:.3e}; "
          f"reading: prefill vs the {seq + 1}-token train pass "
          f"{by_pos.max().item():.3e}, worst at positions "
          f"{worst.indices.tolist()} ({worst_errs}), "
          f"median over positions {by_pos.median().item():.2e}; launches "
          f"{counts}", flush=True)
    check(err <= TF_TOL * top, f"phase {tag}: f32 teacher forcing decode "
          f"err {err}")
    check(err_pre <= TF_TOL * top, f"phase {tag}: f32 teacher forcing "
          f"prefill err {err_pre}")
    del model, caches, ref, ref_seq, pre, dec, kw
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def _mixer_steps(dev, tag: str, cfg, tol: float) -> None:
    """One recurrent mixer of ``cfg`` at full width in float32: a prefill
    over STEP_TOKENS tokens from a zero state against step-by-step decode
    over the same tokens, outputs and final state within ``tol`` (the
    reference's ``tests/test_layers.py`` case at full width)."""
    import torch
    from repro_torch.models import recurrent as rec
    spec = cfg.stages[0].pattern[0]
    r, d = spec.recurrent, cfg.d_model
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    if spec.mixer == "rglru":
        p = rec.init_rglru(d, r, gen, dev)
        fwd = rec.rglru_fwd
        state0 = rec.rglru_init_state(BATCH, r.d_state or d, r.conv_width,
                                      torch.float32, dev)
    else:
        p = rec.init_rwkv6(d, r, gen, dev)
        fwd = rec.rwkv6_fwd
        state0 = rec.rwkv6_init_state(BATCH, d, r.n_heads or d // 64,
                                      torch.float32, dev)
    x = torch.randn(BATCH, STEP_TOKENS, d, device=dev, generator=gen)
    (y_all, st_all), t_pre = _wall(lambda: fwd(p, x, r, state0))

    def steps():
        st, ys = state0, []
        for i in range(STEP_TOKENS):
            y, st = fwd(p, x[:, i:i + 1], r, st)
            ys.append(y)
        return torch.cat(ys, 1), st
    (y_steps, st), t_steps = _wall(steps)
    err = (y_steps - y_all).abs().max().item()
    err_state = max((a - b).abs().max().item() for a, b in zip(st, st_all))
    print(f"[{tag}] {spec.mixer} mixer, d {d}, float32, {BATCH} x "
          f"{STEP_TOKENS} tokens: prefill {t_pre:.2f} ms, {STEP_TOKENS} "
          f"decode steps {t_steps:.2f} ms; decode vs prefill max_abs_err "
          f"{err:.3e}, state {err_state:.3e} (tol {tol:.0e}, max|y| "
          f"{y_all.abs().max().item():.3f})", flush=True)
    check(err <= tol and err_state <= tol,
          f"phase {tag}: decode vs prefill {err} / {err_state}")


def phase_lm_archs(dev, scan_results: list) -> dict:
    """11a the head-dim route, 11b gemma3-4b, 11c yi-9b and yi-34b (16
    layers), 11d recurrentgemma-9b, 11e rwkv6-3b, 11f (run by phase
    10c's ranks) the sequence-parallel scans; returns the serving runs'
    launch counts."""
    import dataclasses
    import gc
    import torch
    from repro_torch.kernels import flash_attention as fa
    t_phase = time.time()
    gc.collect()
    torch.cuda.empty_cache()
    counts = Counter()

    phase_gqa_head_dims(dev)
    print(f"[11a] {time.time() - t_phase:.1f} s", flush=True)

    no_kernel = ((GEMMA, "11b", None), (RG, "11d", None), (RWKV, "11e", None))
    on_kernel = ((YI9, "11c", None), (YI34, "11c", YI34_LAYERS))
    for arch, tag, layers in sorted(no_kernel + on_kernel,
                                    key=lambda c: c[1]):
        t0 = time.time()
        cfg = _cut(arch, layers)
        pre, dec, tf, calls = _serve_lm(
            dev, tag, cfg, P11_PROMPT,
            tf_layers=RWKV_TF_LAYERS if arch == RWKV else None)
        counts.update(pre)
        counts.update(dec)
        n_attn = sum(stage.repeat * sum(s.mixer == "attn"
                                        for s in stage.pattern)
                     for stage in cfg.stages)
        if (arch, tag, layers) in no_kernel:
            check(not calls and not pre.get(fa.NAME) and not dec.get(fa.NAME)
                  and not tf.get(fa.NAME),
                  f"phase {tag} {arch}: flash_attention launched {calls} "
                  f"{pre} {dec} {tf}")
        else:
            check(calls == n_attn and pre.get(fa.NAME) == n_attn
                  and pre.get(fa.TC) == n_attn,
                  f"phase {tag} {arch}: prefill flash_attention launches "
                  f"{calls} {pre}, {n_attn} expected on wgmma")
            check(not dec.get(fa.NAME), f"phase {tag} {arch}: decode "
                  f"flash_attention launches {dec}")
            check(tf.get(fa.NAME) == 2 * n_attn
                  and tf.get(fa.TC) == 2 * n_attn,
                  f"phase {tag} {arch}: teacher-forcing launches {tf}")
        if arch == RG:
            _mixer_steps(dev, tag, cfg, RG_STEP_TOL)
            _tf_f32(dev, tag, _cut(RG, 3, "float32"), REC_TF_SEQ)
        elif arch == RWKV:
            _mixer_steps(dev, tag, cfg, RWKV_STEP_TOL)
            _tf_f32(dev, tag, _cut(RWKV, RWKV_TF_LAYERS, "float32"),
                    REC_TF_SEQ)
        print(f"[{tag}] {arch}: {time.time() - t0:.1f} s", flush=True)

    # 11f: the scans, run by phase 10c's ranks
    for which, tol in (("vector", SCAN_VEC_TOL), ("matrix", SCAN_MAT_TOL)):
        res = [r[which] for r in scan_results]
        err = max(max(r["err"], r["err_last"]) for r in res)
        print(f"[11f] cp_{which}_recurrence, {RANKS} gloo ranks, "
              f"{res[0]['shape_full']} sharded on T: max_abs_err vs the "
              f"meshless scan {err:.3e} (tol {tol:.0e}, max|ref| "
              f"{res[0]['top']:.3f}); {max(r['ms'] for r in res):.1f} ms "
              f"(slowest rank, host clock, gloo); collectives a rank "
              f"{[r['collectives'] for r in res]}", flush=True)
        check(err <= tol, f"phase 11f {which}: err {err}")
        counted = [r["collectives"] for r in res]
        sends = [c.get("collective-permute", {}).get("count", 0)
                 for c in counted]
        check(sends == [6, 6, 4, 0]
              and all(c["all-reduce"]["count"] == 1 for c in counted),
              f"phase 11f {which}: collectives {counted}")
    print(f"[11] phase 11 {time.time() - t_phase:.1f} s", flush=True)
    return dict(counts)


def scan_check(rank: int, mesh, dev) -> dict:
    """11f on one rank of 10c's (data 1, model 4) mesh: the full inputs
    drawn from the seed on every rank, this rank's block of T through
    ``cp_vector_recurrence`` and ``cp_matrix_recurrence``, against its
    slice of the meshless scan (and the final state, on every rank)."""
    import torch
    import torch.distributed as dist
    from repro_torch.models import recurrent as rec
    from repro_torch.parallel.seqscan import (cp_matrix_recurrence,
                                              cp_vector_recurrence)
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    out = {}
    b, t, d = SCAN_VEC
    rows = slice(rank * t // RANKS, (rank + 1) * t // RANKS)
    log_a = -torch.randn(b, t, d, device=dev, generator=gen).abs() * 0.3
    bb = torch.randn(b, t, d, device=dev, generator=gen)
    h0 = torch.randn(b, d, device=dev, generator=gen)
    ref, ref_last = rec.vector_recurrence(log_a, bb, h0)
    blk = (log_a[:, rows].contiguous(), bb[:, rows].contiguous())
    dist.barrier()
    with mesh.counting() as cnt:
        (h, h_last), ms = _wall(lambda: cp_vector_recurrence(
            *blk, h0, mesh=mesh, cp_axis="model", batch_spec="data"))
    out["vector"] = dict(
        shape_full=list(SCAN_VEC), err=(h - ref[:, rows]).abs().max().item(),
        err_last=(h_last - ref_last).abs().max().item(),
        top=ref.abs().max().item(), ms=ms, collectives=cnt.collectives)
    del log_a, bb, ref, blk, h
    b, t, hh, k = SCAN_MAT
    lw = -torch.randn(b, t, hh, k, device=dev, generator=gen).abs() * 0.4
    kk, vv, rr = (torch.randn(b, t, hh, k, device=dev, generator=gen)
                  for _ in range(3))
    u = torch.randn(hh, k, device=dev, generator=gen)
    s0 = torch.randn(b, hh, k, k, device=dev, generator=gen)
    ref, ref_last = rec.matrix_recurrence(lw, kk, vv, rr, u, s0)
    blk = [x[:, rows].contiguous() for x in (lw, kk, vv, rr)]
    dist.barrier()
    with mesh.counting() as cnt:
        (o, s_last), ms = _wall(lambda: cp_matrix_recurrence(
            *blk, u, s0, mesh=mesh, cp_axis="model", batch_spec="data"))
    out["matrix"] = dict(
        shape_full=list(SCAN_MAT), err=(o - ref[:, rows]).abs().max().item(),
        err_last=(s_last - ref_last).abs().max().item(),
        top=ref.abs().max().item(), ms=ms, collectives=cnt.collectives)
    return out


# ---------------------------------------------------------------------------
# phase 12: the encoder, cross-attention and prefix-LM serving
# ---------------------------------------------------------------------------

WHISPER = "whisper-base"  # src/repro/configs/whisper_base.py
PALI = "paligemma-3b"     # src/repro/configs/paligemma_3b.py
P12_BATCH = 8             # a batched server's requests
# whisper's longest previous-text prompt, half its 448-token text context
# (224 + GEN stays inside it)
WHISPER_PROMPT = 224
# (B, frames, heads, kv heads, head_dim) of whisper's encoder attention
WHISPER_ATTN = (P12_BATCH, 1500, 8, 8, 64)
PALI_PROMPT = 256         # the text part after paligemma's 256 patches
PALI_TF_LAYERS = 2        # depth of paligemma's float32 teacher forcing
PALI_TF_SEQ = 512         # its tokens after the 256 patches
CROSS_TOL = 1e-5          # the cross cache vs gqa_project_kv (x max|ref|)


def phase_frontends(dev) -> dict:
    """12a whisper-base (6 + 6 layers) and 12b paligemma-3b (18 layers)
    at full width and depth, bf16, seeded weights, P12_BATCH requests of
    seeded stub frames or patches on the card and a ``synth_tokens``
    prompt, GEN greedy tokens (``_serve_lm``); then float32 teacher
    forcing, whisper at full depth (S 224) and paligemma at 2 layers (256
    patches + 512 tokens).  whisper's prefill launches ``flash_attention``
    once a self-attention layer (the encoder's non-causal, the decoder's
    causal), all ``wgmma``; its decode and every paligemma pass (prefix-LM
    and head_dim 256) launch none.  Returns the served runs' launches."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    t_phase = time.time()
    counts = Counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)

    t0 = time.time()
    cfg = _cut(WHISPER)
    frames = torch.randn(P12_BATCH, cfg.n_frontend_tokens, cfg.d_model,
                         device=dev, generator=gen)
    pre, dec, tf, calls = _serve_lm(dev, "12a", cfg, WHISPER_PROMPT,
                                    batch=P12_BATCH, stub=frames)
    n_attn = cfg.encoder.n_layers + cfg.n_layers
    check(calls == n_attn and pre.get(fa.NAME) == n_attn
          and pre.get(fa.TC) == n_attn,
          f"phase 12a: prefill flash_attention launches {calls} {pre}, "
          f"{n_attn} expected on wgmma")
    check(not dec.get(fa.NAME), f"phase 12a: decode launches {dec}")
    check(tf.get(fa.NAME) == 2 * n_attn and tf.get(fa.TC) == 2 * n_attn,
          f"phase 12a: teacher-forcing launches {tf}")
    counts.update(pre)
    counts.update(dec)
    _tf_f32(dev, "12a", _cut(WHISPER, dtype="float32"), WHISPER_PROMPT,
            stub=frames[:BATCH])
    print(f"[12a] {WHISPER}: {time.time() - t0:.1f} s", flush=True)

    t0 = time.time()
    cfg = _cut(PALI)
    patches = torch.randn(P12_BATCH, cfg.n_frontend_tokens, cfg.d_model,
                          device=dev, generator=gen)
    pre, dec, tf, calls = _serve_lm(dev, "12b", cfg, PALI_PROMPT,
                                    batch=P12_BATCH, stub=patches)
    check(not calls and not pre.get(fa.NAME) and not dec.get(fa.NAME)
          and not tf.get(fa.NAME),
          f"phase 12b: flash_attention launched {calls} {pre} {dec} {tf}")
    counts.update(pre)
    counts.update(dec)
    _tf_f32(dev, "12b", _cut(PALI, PALI_TF_LAYERS, "float32"), PALI_TF_SEQ,
            stub=patches[:BATCH])
    print(f"[12b] {PALI}: {time.time() - t0:.1f} s", flush=True)
    print(f"[12] phase 12 {time.time() - t_phase:.1f} s", flush=True)
    return dict(counts)


# ---------------------------------------------------------------------------
# phase 13: training
# ---------------------------------------------------------------------------

SPEC_LR = 0.05            # examples/train_lm.py's SGD rate
TRAIN_STEPS = 5
# 13b/13d's AdamW rate.  At h2o's full width the first Adam steps move
# every weight by about the rate.  At 3e-4 with 2 warmup steps the loss
# of the 24-layer model rose over 5 steps on the card (PERF.md §6); the
# reference rises there too at 1 layer and a 256-token vocabulary
# (tests/test_torch_train_wide.py), and at 2 layers and the full
# vocabulary both packages jump at step 2 and end below the start
# (tests/torch_train_cases.py run as a script).  At 3e-5 all of them fall
TRAIN_LR = 3e-5
TRAIN_BATCH = 2           # 13b: 2 x (2048 + 1) tokens a step
TRAIN_SEQ = 2048
TRAIN_CUT = 2             # 13c/13d: h2o at full width, 2 layers
TRAIN_CUT_SEQ = 256       # 13c/13d: batch 1 x (256 + 1)
RESUME_RTOL = 1e-6        # tests/test_substrate.py:187
STEP_LR = 3e-4            # the issue's AdamW rate: 13c's full step, a
                          # reading in 13b
STATE_TOL = 1e-5          # tests/test_torch_train_state.py


def _train_step_profiled(fn, tag: str, what: str, top: int = 0) -> tuple:
    """Run ``fn`` once under the profiler, launch counts set to 0 just
    before it and read just after: returns (fn's result, a record of the
    wall ms, the device busy ms and device ops the profiler recorded, the
    device span between CUDA events around the call, and the launches)
    and prints one line, and with ``top`` the top kernels.  The span
    bounds the busy time from above; a busy time well under it on a
    device-bound step means the profiler lost records."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import launch_counts, reset_launch_counts
    torch.cuda.synchronize()
    reset_launch_counts()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ev[0].record()
        out = fn()
        ev[1].record()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    counts = launch_counts()
    rows = sorted((e for e in prof.key_averages() if e.device_time_total > 0),
                  key=lambda e: -e.device_time_total)
    rec = {"wall_ms": wall, "span_ms": ev[0].elapsed_time(ev[1]),
           "busy_ms": sum(e.device_time_total for e in rows) / 1e3,
           "ops": sum(e.count for e in rows), "launches": counts}
    print(f"[{tag}] {what}: wall {wall:.2f} ms, device span "
          f"{rec['span_ms']:.2f} ms (events), busy {rec['busy_ms']:.2f} ms "
          f"in {rec['ops']} device ops (profiler), launches {counts}",
          flush=True)
    for e in rows[:top]:
        print(f"[{tag}]   {e.device_time_total / 1e3:8.2f} ms  "
              f"x{e.count:<5d} {e.key[:90]}", flush=True)
    return out, rec


def phase_train_spectral(dev) -> dict:
    """13a: the learned spectral filter at croft-1024 (``Croft3D`` packed
    r2c, ``local_impl="pallas"``, meshless): the target from seeded true
    params (as ``examples/train_lm.py:85-89``), step 0's loss and both
    gradients against the same loss through ``torch.fft.rfftn`` autograd
    (GRAD_TOL of max|ref|), then TRAIN_STEPS SGD steps at SPEC_LR from the
    identity init, each profiled: the loss falls, and ``fft4step``,
    ``unpack_two_for_one`` and ``spectral_scale_full`` launch in every
    step.  Returns the steps' launches."""
    import torch
    from repro_torch.core import Croft3D, FFTOptions
    from repro_torch.models.spectral import (init_spectral_filter_params,
                                             spectral_filter_apply)
    from repro_torch.train import make_spectral_train_step
    t_phase = time.time()
    shape = (FULL,) * 3
    torch.cuda.reset_peak_memory_stats(dev)
    plan = Croft3D(shape, problem="r2c", strategy="packed",
                   opts=FFTOptions(local_impl="pallas"))
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    x = torch.randn(shape, device=dev, generator=gen)
    with torch.no_grad():
        true = {"gate": 1.0 + 0.3 * torch.randn(shape, device=dev,
                                                generator=gen),
                "filter": 1.0 + 0.3 * torch.randn(plan.spectrum_shape,
                                                  device=dev, generator=gen)}
        target = spectral_filter_apply(plan, true, x)
    del true
    step, loss_fn = make_spectral_train_step(plan, lr=SPEC_LR)
    params = init_spectral_filter_params(gen, plan)      # the identity
    names = ("gate", "filter")
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    loss0 = loss_fn(leaves, x, target)
    got = torch.autograd.grad(loss0, [leaves[k] for k in names])
    n3 = float(FULL ** 3)
    d = torch.fft.rfftn(leaves["gate"] * x) * leaves["filter"] - target
    oracle = torch.sum(torch.real(d * torch.conj(d))) / n3
    del d
    want = torch.autograd.grad(oracle, [leaves[k] for k in names])
    loss_err = abs(loss0.item() - oracle.item()) / abs(oracle.item())
    errs = {k: max_abs_diff(g, w) / max_abs(w)
            for k, g, w in zip(names, got, want)}
    del leaves, loss0, oracle, got, want
    torch.cuda.empty_cache()
    print(f"[13a] step 0 against torch.fft.rfftn autograd: loss rel err "
          f"{loss_err:.3e}, gate.grad {errs['gate']:.3e}, filter.grad "
          f"{errs['filter']:.3e} (tol {GRAD_TOL:.0e})", flush=True)
    check(loss_err < GRAD_TOL and all(e < GRAD_TOL for e in errs.values()),
          f"phase 13a: step 0 against the oracle {loss_err} {errs}")
    counts, losses = Counter(), []
    for i in range(TRAIN_STEPS):
        (params, loss), rec = _train_step_profiled(
            lambda: step(params, x, target), "13a", f"step {i}",
            top=8 if i == TRAIN_STEPS - 1 else 0)
        losses.append(loss.item())
        counts.update(rec["launches"])
        missing = [k for k in ("fft4step", "unpack_two_for_one",
                               "spectral_scale_full")
                   if not rec["launches"].get(k)]
        check(not missing, f"phase 13a: step {i} launched no {missing}")
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    print(f"[13a] losses {['%.4f' % v for v in losses]}; launches over "
          f"{TRAIN_STEPS} steps {dict(counts)} (hermitian_extend "
          f"{counts.get('hermitian_extend', 0)}); peak {peak:.2f} GiB; "
          f"{time.time() - t_phase:.1f} s", flush=True)
    check(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
          f"phase 13a: the loss did not fall {losses}")
    del params, x, target
    torch.cuda.empty_cache()
    return dict(counts)


def phase_train_lm(dev) -> dict:
    """13b: h2o-danube-3-4b at full width and depth, bf16 compute, fp32
    masters, bf16 moments, remat on, AdamW at TRAIN_LR: TRAIN_STEPS steps
    of ``make_train_step`` on ``SyntheticDataset`` batches of TRAIN_BATCH x
    (TRAIN_SEQ + 1), each profiled; finite losses, the last below the
    first (``tests/test_models_smoke.py:48-64``), no ``flash_attention``
    launch (a grad-taking pass runs the blockwise core), the step's
    6·N·tokens bound and the share of it.  Returns the steps' launches."""
    import dataclasses
    import gc
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.train import OptConfig, init_train_state, make_train_step
    from repro_torch.train.data import SyntheticDataset
    t_phase = time.time()
    cfg = _cut(ARCH)
    ocfg = OptConfig(lr=TRAIN_LR, warmup_steps=2, decay_steps=10,
                     moment_dtype="bfloat16")
    torch.cuda.reset_peak_memory_stats(dev)
    state, t_init = _wall(lambda: init_train_state(
        torch.Generator(device=dev).manual_seed(SEED), cfg, ocfg,
        device=dev))
    n_params = sum(p.numel() for p in state["params"].parameters())
    print(f"[13b] {ARCH}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"vocab {cfg.vocab}, {n_params:.4e} parameters; train state "
          f"(fp32 masters, bf16 moments) in {t_init:.0f} ms, "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB",
          flush=True)
    step = make_train_step(cfg, ocfg, None, TRAIN_BATCH, kv_block=KV_BLOCK)
    ds = SyntheticDataset(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, seed=SEED,
                          device=dev)
    counts, losses, recs = Counter(), [], []
    for i in range(TRAIN_STEPS):
        batch = ds.batch_at(i)
        (state, metrics), rec = _train_step_profiled(
            lambda: step(state, batch), "13b", f"step {i}",
            top=12 if i == TRAIN_STEPS - 1 else 0)
        losses.append(metrics["loss"].item())
        counts.update(rec["launches"])
        recs.append(rec)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    tokens = TRAIN_BATCH * TRAIN_SEQ
    bound = 6.0 * n_params * tokens / BF16_FLOP_S * 1e3
    busy = statistics.median(r["busy_ms"] for r in recs[1:])
    span = statistics.median(r["span_ms"] for r in recs[1:])
    wall = statistics.median(r["wall_ms"] for r in recs[1:])
    print(f"[13b] losses {['%.4f' % v for v in losses]}; the step's bound "
          f"6·N·tokens = {6.0 * n_params * tokens:.3e} FLOP over "
          f"{BF16_FLOP_S:.3e} FLOP/s = {bound:.2f} ms; median of steps "
          f"1-{TRAIN_STEPS - 1}: busy {busy:.2f} ms ({bound / busy:.1%} of "
          f"the bound), span {span:.2f} ms ({bound / span:.1%}), wall "
          f"{wall:.2f} ms; peak {peak:.2f} GiB; "
          f"{time.time() - t_phase:.1f} s", flush=True)
    check(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
          f"phase 13b: losses {losses}")
    check(not counts.get(fa.NAME),
          f"phase 13b: the train step launched flash_attention {counts}")
    del state, step, metrics
    gc.collect()
    torch.cuda.empty_cache()
    # a reading, not a check: the same steps from the same state at the
    # issue's rate STEP_LR (PERF.md §6: at 24 layers the loss rose there)
    ocfg = dataclasses.replace(ocfg, lr=STEP_LR)
    state = init_train_state(torch.Generator(device=dev).manual_seed(SEED),
                             cfg, ocfg, device=dev)
    step = make_train_step(cfg, ocfg, None, TRAIN_BATCH, kv_block=KV_BLOCK)
    high = [step(state, ds.batch_at(i))[1]["loss"].item()
            for i in range(TRAIN_STEPS)]
    print(f"[13b] the same steps at rate {STEP_LR:g}: losses "
          f"{['%.4f' % v for v in high]} (a reading)", flush=True)
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    return dict(counts)


def _adamw_plain(p0, m, v, lr, step: int, ocfg, decays: bool):
    """The master after an AdamW step, from the step's own moments (clip
    included), in float64: the reference's formula
    (``repro/train/optimizer.py:adamw_update``)."""
    import torch
    bc1, bc2 = 1 - ocfg.b1 ** step, 1 - ocfg.b2 ** step
    p0, m, v = p0.double(), m.double(), v.double()
    delta = (m / bc1) / (torch.sqrt(v / bc2) + ocfg.eps)
    if decays:
        delta = delta + ocfg.weight_decay * p0
    return p0 - lr * delta


def _check_full_step(cfg, cpu, card, batch) -> None:
    """13c, the step: one ``make_train_step`` (fp32 moments, STEP_LR)
    from one state on the CPU and on the card.  The loss, the learning
    rate, the gradient norm and the clip scale within STATE_TOL
    (relative); ``m`` and ``v``, the clipped gradient's moments, within
    GRAD_TOL of max|ref| per leaf, as 13c holds the gradient; each
    master on the card within STATE_TOL of max|ref| of the AdamW formula
    (``_adamw_plain``, float64) applied to the card's own moments, with
    weight decay where the reference's layout has >= 2 dims (a layer's
    norm scales count the repeat axis the reference stacks them on).
    The masters card against CPU are printed, and held only within 2·lr
    (+ STATE_TOL of max|ref|): Adam's first update is g / (|g| + eps),
    so an element whose gradient lies within the gradient's tolerance of
    zero may move up to lr either way on each side."""
    import torch
    from repro_torch.train import OptConfig, make_train_step
    from repro_torch.train.optimizer import init_opt_state
    ocfg = OptConfig(lr=STEP_LR, warmup_steps=2, decay_steps=10)
    p0 = {k: v.detach().clone() for k, v in card.named_parameters()}
    states = {n: {"params": mdl,
                  "opt": init_opt_state(dict(mdl.named_parameters()), ocfg)}
              for n, mdl in (("cpu", cpu), ("card", card))}
    step = make_train_step(cfg, ocfg, None, 1, kv_block=KV_BLOCK)
    met = {}
    for n, st in states.items():
        t0 = time.time()
        met[n] = {k: float(v) for k, v in step(st, batch)[1].items()
                  if k in ("loss", "lr", "grad_norm", "clip_scale")}
        print(f"[13c] full step on the {n}: {time.time() - t0:.1f} s; "
              f"{met[n]}", flush=True)
    scal = max(abs(met["card"][k] - w) / abs(w)
               for k, w in met["cpu"].items())
    mom = max((float((states["card"]["opt"][x][k].cpu() - w).abs().max()
                     / w.abs().max().clamp_min(1e-30)), f"{x}:{k}")
              for x in ("m", "v")
              for k, w in states["cpu"]["opt"][x].items())
    lr = met["card"]["lr"]
    stacked = {k for k in p0 if k.startswith(("stages.", "encoder.layers."))}
    cpu_p = dict(cpu.named_parameters())
    formula, vs_cpu, past, over = (0.0, ""), (0.0, ""), 0, -1.0
    for k, p in card.named_parameters():
        scale = float(p0[k].abs().max().clamp_min(1e-30))
        want = _adamw_plain(p0[k], states["card"]["opt"]["m"][k],
                            states["card"]["opt"]["v"][k], lr, 1, ocfg,
                            p.ndim + (k in stacked) >= 2)
        formula = max(formula, (float((p.double() - want).abs().max())
                                / scale, k))
        d = (p.cpu() - cpu_p[k]).abs()
        vs_cpu = max(vs_cpu, (float(d.max()) / scale, k))
        past += int((d > STATE_TOL * scale).sum())
        over = max(over, float(d.max()) - 2 * lr - STATE_TOL * scale)
    n = sum(p.numel() for p in p0.values())
    print(f"[13c] full step, card vs CPU: loss/lr/grad_norm/clip_scale "
          f"rel err {scal:.3e} (tol {STATE_TOL:.0e}); moments worst "
          f"{mom[1]} {mom[0]:.3e} (tol {GRAD_TOL:.0e}); masters against "
          f"the AdamW formula on the card's moments worst {formula[1]} "
          f"{formula[0]:.3e} (tol {STATE_TOL:.0e}); masters card vs CPU "
          f"worst {vs_cpu[1]} {vs_cpu[0]:.3e} of max|ref|, {past} of {n} "
          f"elements past {STATE_TOL:.0e} of max|ref|, none more than "
          f"2·lr = {2 * lr:.3e} past it: {over <= 0}", flush=True)
    check(scal <= STATE_TOL and mom[0] <= GRAD_TOL
          and formula[0] <= STATE_TOL and over <= 0,
          f"phase 13c: the full step {scal} {mom} {formula} {over}")


def phase_train_cut(dev) -> dict:
    """13c: h2o at full width cut to TRAIN_CUT layers, float32, batch 1 x
    TRAIN_CUT_SEQ: one ``value_and_grad`` of ``loss_fn`` on the card and
    on the CPU from one seeded state, the loss and every gradient leaf
    within GRAD_TOL of max|ref| (the CPU's); then one full
    ``make_train_step`` on both from that state (``_check_full_step``).
    13d: the same cut in bf16:
    4 straight steps, and 2 steps, ``CheckpointManager.save`` into a
    temporary directory, ``restore`` into a fresh state, 2 more; the
    losses of steps 3-4 within RESUME_RTOL.  Returns 13d's launches."""
    import gc
    import shutil
    import tempfile
    import torch
    from repro_torch.device import full_fp32_matmul
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import init_params
    from repro_torch.train import OptConfig, init_train_state, make_train_step
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.data import SyntheticDataset
    from repro_torch.train.train_step import value_and_grad
    t_phase = time.time()
    full_fp32_matmul(dev)
    cfg = _cut(ARCH, TRAIN_CUT, "float32")
    cpu = init_params(cfg, torch.Generator().manual_seed(SEED), "cpu")
    card = init_params(cfg, None, "meta").to_empty(device=dev)
    card.load_state_dict(cpu.state_dict())
    batch = SyntheticDataset(cfg.vocab, TRAIN_CUT_SEQ, 1,
                             seed=SEED).batch_at(0)
    t0 = time.time()
    want_loss, _, want = value_and_grad(
        cpu, cfg, {k: torch.from_numpy(v) for k, v in batch.items()},
        kv_block=KV_BLOCK)
    t_cpu = time.time() - t0
    reset_launch_counts()
    got_loss, _, got = value_and_grad(
        card, cfg, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()},
        kv_block=KV_BLOCK)
    counts = launch_counts()
    loss_err = abs(got_loss.item() - want_loss.item()) / abs(want_loss.item())
    worst = max((float((got[k].cpu() - w).abs().max() / w.abs().max()), k)
                for k, w in want.items())
    print(f"[13c] {ARCH} at {TRAIN_CUT} layers, float32, 1 x "
          f"{TRAIN_CUT_SEQ}: card vs CPU loss rel err {loss_err:.3e}, worst "
          f"gradient leaf {worst[1]} {worst[0]:.3e} (tol {GRAD_TOL:.0e}); "
          f"CPU {t_cpu:.1f} s; launches {counts}", flush=True)
    check(loss_err < GRAD_TOL and worst[0] < GRAD_TOL,
          f"phase 13c: card vs CPU {loss_err} {worst}")
    del got, want
    _check_full_step(cfg, cpu, card, batch)
    del cpu, card
    gc.collect()
    torch.cuda.empty_cache()

    cfg = _cut(ARCH, TRAIN_CUT)
    ocfg = OptConfig(lr=TRAIN_LR, warmup_steps=2, decay_steps=10,
                     moment_dtype="bfloat16")
    step = make_train_step(cfg, ocfg, None, 1, kv_block=KV_BLOCK)
    ds = SyntheticDataset(cfg.vocab, TRAIN_CUT_SEQ, 1, seed=SEED, device=dev)

    def fresh():
        return init_train_state(torch.Generator(device=dev).manual_seed(SEED),
                                cfg, ocfg, device=dev)

    reset_launch_counts()
    state = fresh()
    full = [step(state, ds.batch_at(i))[1]["loss"].item() for i in range(4)]
    del state
    state = fresh()
    for i in range(2):
        step(state, ds.batch_at(i))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        mgr = CheckpointManager(tmp, keep=1)
        t0 = time.time()
        mgr.save(2, state)
        mgr.wait()
        t_save = time.time() - t0
        del state
        gc.collect()
        t0 = time.time()
        state = mgr.restore(fresh())
        t_restore = time.time() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    resumed = [step(state, ds.batch_at(i))[1]["loss"].item()
               for i in range(2, 4)]
    counts = launch_counts()
    err = max(abs(a - b) / abs(b) for a, b in zip(resumed, full[2:]))
    print(f"[13d] bf16, {TRAIN_CUT} layers: straight {full}, resumed at 2 "
          f"{resumed}: max rel err {err:.3e} (tol {RESUME_RTOL:.0e}); save "
          f"{t_save:.1f} s, restore {t_restore:.1f} s; "
          f"{time.time() - t_phase:.1f} s for 13c-13d", flush=True)
    check(err <= RESUME_RTOL, f"phase 13d: resume {resumed} vs {full}")
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def phase_train(dev) -> dict:
    """Phase 13: 13a, 13b, 13c and 13d; returns the launches of the
    driven runs."""
    t0 = time.time()
    counts = Counter(phase_train_spectral(dev))
    counts.update(phase_train_lm(dev))
    counts.update(phase_train_cut(dev))
    print(f"[13] phase 13 {time.time() - t0:.1f} s", flush=True)
    return dict(counts)


# --------------------------------------------------------------------------
# phase 14: the LM on a mesh
# --------------------------------------------------------------------------

SH_MODEL = 2              # ranks on the model axis of the (2, 2) mesh
SH_TRAIN_LAYERS = 2       # 14a: float32 masters of 2 layers, 2.2 GB
SH_TRAIN_SEQ = 1024       # 14a: global batch 2 x (1024 + 1)
SH_BF16_LAYERS = 4
# 14a's bf16 steps: at 3 the last loss is above the first in the meshless
# port too (the seeded model's Adam jump at step 2, PERF.md §6); at 5,
# as 13b, it is below
SH_BF16_STEPS = TRAIN_STEPS
SH_TRAJ_RTOL = 5e-2       # bf16 trajectories (tests/test_torch_train_steps.py)
SH_PROMPT = 4096          # 14b: 2048 positions and 2048 slots a rank
SH_TF_LAYERS = 2          # 14b's float32 decode check
SH_TF_STEPS = 8
SH_PREFILL = 2048         # 14c's prompts
SH_CAPACITY = 4.0         # 14c: mixtral's factor, where no pair drops
SH_STRIDE = 16            # 14c: logits held at every 16th position
SH_LOSS_RTOL = 2e-4       # tests/test_parallel.py:96
SH_BF16_TOL = 5e-2        # bf16 serving (tests/test_torch_lm_serve.py)
SH_TIMEOUT_S = 600


def _sh_coords() -> list:
    """The (data 2, model 2) mesh's coords of every rank, row-major as
    ``make_local_mesh`` lays them out."""
    return [{"data": r // SH_MODEL, "model": r % SH_MODEL}
            for r in range(RANKS)]


def _sh_prefill_ref(dev, cfg, wdir: str, tag: str) -> None:
    """14c's reference: the meshless prefill's logits at every
    SH_STRIDE-th position of 2 x SH_PREFILL ``synth_tokens``, saved for
    the ranks."""
    import gc
    import torch
    from repro_torch.models import forward, init_caches, init_params
    from repro_torch.models.model import logits as lm_logits
    from repro_torch.train.data import synth_tokens
    t0 = time.time()
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                        dev)
    tokens = torch.from_numpy(synth_tokens(SEED, 0, BATCH, SH_PREFILL,
                                           cfg.vocab)).to(dev)
    caches = init_caches(cfg, BATCH, SH_PREFILL, dtype=torch.float32,
                         device=dev)
    with torch.no_grad():
        hidden, _ = forward(model, cfg, tokens, mode="prefill",
                            caches=caches, kv_block=KV_BLOCK,
                            return_hidden=True)
        ref = lm_logits(model, cfg, hidden[:, ::SH_STRIDE]).cpu()
    torch.save(ref, os.path.join(wdir, f"{tag}_ref.pt"))
    print(f"[14c] {tag}: meshless reference prefill {BATCH} x {SH_PREFILL} "
          f"in {time.time() - t0:.1f} s", flush=True)
    del model, caches, hidden
    gc.collect()
    torch.cuda.empty_cache()


def _sh_refs(dev, wdir: str) -> None:
    """The meshless references of 14a and 14c, computed on the card in
    this process and saved for the ranks: 14a's step-0 gradient as each
    rank's slices (with each leaf's max|ref|) and two steps' losses."""
    import gc
    import torch
    from repro_torch.core.decomposition import spec_slices
    from repro_torch.parallel import sharding as sh
    from repro_torch.train import OptConfig, init_train_state, make_train_step
    from repro_torch.train.data import SyntheticDataset
    from repro_torch.train.train_step import value_and_grad
    t0 = time.time()
    cfg = _cut(ARCH, SH_TRAIN_LAYERS, "float32")
    ocfg = OptConfig(lr=TRAIN_LR, warmup_steps=1, decay_steps=8)
    state = init_train_state(torch.Generator(device=dev).manual_seed(SEED),
                             cfg, ocfg, device=dev)
    ds = SyntheticDataset(cfg.vocab, SH_TRAIN_SEQ, BATCH, seed=SEED,
                          device=dev)
    model = state["params"]
    loss, _, grads = value_and_grad(model, cfg, ds.batch_at(0),
                                    kv_block=KV_BLOCK)

    class Stub:
        shape = {"data": RANKS // SH_MODEL, "model": SH_MODEL}
    specs = sh.param_specs(model, Stub, sh.MeshAxes())
    scale = {n: float(g.abs().max()) for n, g in grads.items()}
    for r, coords in enumerate(_sh_coords()):
        torch.save({"scale": scale, "grads": {
            n: g[spec_slices(specs[n], g.shape, Stub.shape, coords)].cpu()
            for n, g in grads.items()}}, os.path.join(wdir, f"grad{r}.pt"))
    del grads
    step = make_train_step(cfg, ocfg, None, BATCH, kv_block=KV_BLOCK)
    losses = []
    for i in range(2):
        state, m = step(state, ds.batch_at(i))
        losses.append(m["loss"].item())
    del state, step, model, m
    gc.collect()
    torch.cuda.empty_cache()
    cfg = _cut(ARCH, SH_BF16_LAYERS, "bfloat16")
    ocfg = _sh_bf16_opt()
    state = init_train_state(torch.Generator(device=dev).manual_seed(SEED),
                             cfg, ocfg, device=dev)
    step = make_train_step(cfg, ocfg, None, BATCH, kv_block=KV_BLOCK)
    bf16 = []
    for i in range(SH_BF16_STEPS):
        state, m = step(state, ds.batch_at(i))
        bf16.append(m["loss"].item())
    with open(os.path.join(wdir, "losses.json"), "w") as f:
        json.dump({"step0": loss.item(), "losses": losses, "bf16": bf16}, f)
    print(f"[14a] meshless reference on the card: step-0 loss "
          f"{loss.item():.6f}, losses {losses}; bf16 at {SH_BF16_LAYERS} "
          f"layers {bf16}; {time.time() - t0:.1f} s", flush=True)
    del state, step, m
    gc.collect()
    torch.cuda.empty_cache()
    _sh_prefill_ref(dev, _sh_moe_cfg(), wdir, "mixtral")
    _sh_prefill_ref(dev, _cut(RG, 3, "float32"), wdir, "recurrentgemma")


def _sh_bf16_opt():
    """14a's bf16 optimizer: 13b's (AdamW TRAIN_LR, bf16 moments)."""
    from repro_torch.train import OptConfig
    return OptConfig(lr=TRAIN_LR, warmup_steps=2, decay_steps=10,
                     moment_dtype="bfloat16")


def _sh_moe_cfg():
    """14c's mixtral: 1 layer at full width, float32, capacity factor
    SH_CAPACITY."""
    import dataclasses
    cfg = _cut(MX, 1, "float32")
    spec = cfg.stages[0].pattern[0]
    moe = dataclasses.replace(spec.moe, capacity_factor=SH_CAPACITY)
    return dataclasses.replace(cfg, stages=(dataclasses.replace(
        cfg.stages[0], pattern=(dataclasses.replace(spec, moe=moe),)),))


def _sh_train(rank, mesh, dev, fails, rec) -> None:
    """14a on this rank."""
    import gc
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.train import OptConfig, init_train_state, make_train_step
    from repro_torch.train.data import SyntheticDataset, batch_sharding
    from repro_torch.train.train_step import make_shard_ctx, value_and_grad
    wdir = rec["wdir"]
    cfg = _cut(ARCH, SH_TRAIN_LAYERS, "float32")
    ocfg = OptConfig(lr=TRAIN_LR, warmup_steps=1, decay_steps=8)
    t0 = time.time()
    state = init_train_state(torch.Generator(device=dev).manual_seed(SEED),
                             cfg, ocfg, mesh=mesh)
    shard = make_shard_ctx(mesh, BATCH)
    ds = SyntheticDataset(cfg.vocab, SH_TRAIN_SEQ, BATCH, seed=SEED,
                          device=dev, sharding=batch_sharding(
                              shard, BATCH, ["tokens"]))
    t_init = time.time() - t0
    want = torch.load(os.path.join(wdir, f"grad{rank}.pt"))
    ref = json.load(open(os.path.join(wdir, "losses.json")))
    model = state["params"]
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with mesh.counting() as cnt:
        loss, _, grads = value_and_grad(model, cfg, ds.batch_at(0),
                                        shard=shard, kv_block=KV_BLOCK)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = Counter(launch_counts())
    worst, leaf = 0.0, None
    for n, g in grads.items():
        e = float((g.float().cpu() - want["grads"][n]).abs().max()) \
            / max(want["scale"][n], 1e-30)
        if e > worst:
            worst, leaf = e, n
    ok_loss = abs(loss.item() - ref["step0"]) <= SH_LOSS_RTOL * abs(
        ref["step0"])
    rec["14a_step0"] = dict(loss=loss.item(), ref=ref["step0"],
                            grad_err=worst, worst_leaf=leaf,
                            collectives=cnt.collectives, wall_s=wall,
                            init_s=t_init)
    if not ok_loss:
        fails.append(f"14a step-0 loss {loss.item()} vs {ref['step0']}")
    if not worst <= GRAD_TOL:
        fails.append(f"14a gradient block {leaf}: {worst:.3e} of max|ref|")
    del grads, want
    step = make_train_step(cfg, ocfg, mesh, BATCH, kv_block=KV_BLOCK)
    losses, steps = [], []
    for i in range(2):
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with mesh.counting() as cnt:
            state, m = step(state, ds.batch_at(i))
            losses.append(m["loss"].item())
        steps.append({"wall_s": time.perf_counter() - t0,
                      "collectives": cnt.collectives})
        launches.update(launch_counts())
    rec["14a_f32"] = dict(losses=losses, ref=ref["losses"], steps=steps)
    if any(abs(a - b) > SH_LOSS_RTOL * abs(b)
           for a, b in zip(losses, ref["losses"])):
        fails.append(f"14a losses {losses} vs meshless {ref['losses']}")
    del state, step, model, m
    gc.collect()
    torch.cuda.empty_cache()

    # bf16 at 4 layers, SH_BF16_STEPS steps at AdamW TRAIN_LR
    cfg = _cut(ARCH, SH_BF16_LAYERS, "bfloat16")
    ocfg = _sh_bf16_opt()
    torch.cuda.reset_peak_memory_stats(dev)
    state = init_train_state(torch.Generator(device=dev).manual_seed(SEED),
                             cfg, ocfg, mesh=mesh)
    step = make_train_step(cfg, ocfg, mesh, BATCH, kv_block=KV_BLOCK)
    ds = SyntheticDataset(cfg.vocab, SH_TRAIN_SEQ, BATCH, seed=SEED,
                          device=dev, sharding=batch_sharding(
                              shard, BATCH, ["tokens"]))
    losses, steps = [], []
    for i in range(SH_BF16_STEPS):
        batch = ds.batch_at(i)
        with mesh.counting() as cnt:
            if rank == 0:
                (state, m), prof = _train_step_profiled(
                    lambda: step(state, batch), "14a", f"bf16 step {i} "
                    "(rank 0)")
                steps.append({k: prof[k] for k in
                              ("wall_ms", "span_ms", "busy_ms", "ops")})
            else:
                reset_launch_counts()
                t0 = time.perf_counter()
                state, m = step(state, batch)
                torch.cuda.synchronize()
                steps.append({"wall_ms": (time.perf_counter() - t0) * 1e3})
            losses.append(m["loss"].item())
        steps[-1]["collectives"] = cnt.collectives
        launches.update(launch_counts())
    rec["14a_bf16"] = dict(losses=losses, steps=steps,
                           peak_gib=torch.cuda.max_memory_allocated(dev)
                           / 2**30)
    rec["14a_bf16"]["ref"] = ref["bf16"]
    if not (all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]
            and all(abs(a - b) <= SH_TRAJ_RTOL * abs(b)
                    for a, b in zip(losses, ref["bf16"]))):
        fails.append(f"14a bf16 losses {losses} (meshless {ref['bf16']})")
    rec["launches"].update(launches)
    del state, step, m
    gc.collect()
    torch.cuda.empty_cache()


def _sh_serve(rank, mesh, dev, fails, rec) -> None:
    """14b on this rank: the whole model on every rank, the caches
    slot-sharded."""
    import gc
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import init_caches, init_params
    from repro_torch.models.model import batch_rows
    from repro_torch.train import (cast_to_compute, greedy_sample,
                                   make_serve_steps)
    from repro_torch.train.data import synth_tokens
    from repro_torch.train.train_step import make_shard_ctx
    rows = batch_rows(make_shard_ctx(mesh, BATCH), BATCH)
    me = mesh.coords["model"]
    launches = Counter()
    for layers, dtype in ((SH_BF16_LAYERS, "bfloat16"),
                          (SH_TF_LAYERS, "float32")):
        cfg = _cut(ARCH, layers, dtype)
        dt = getattr(torch, dtype)
        torch.cuda.reset_peak_memory_stats(dev)
        model = cast_to_compute(init_params(
            cfg, torch.Generator(device=dev).manual_seed(SEED), dev), dtype)
        gen = SH_TF_STEPS if dtype == "float32" else GEN
        max_len = SH_PROMPT + gen
        prompts = synth_tokens(SEED, 0, BATCH, SH_PROMPT, cfg.vocab)
        pre0, dec0 = make_serve_steps(cfg, BATCH, max_len,
                                      kv_block=KV_BLOCK, device=dev)
        pre1, dec1 = make_serve_steps(cfg, BATCH, max_len,
                                      kv_block=KV_BLOCK, mesh=mesh)
        c0 = init_caches(cfg, BATCH, max_len, dtype=dt, device=dev)
        c1 = init_caches(cfg, BATCH, max_len, dtype=dt, device=dev,
                         mesh=mesh)
        want, _ = pre0(model, prompts, c0)
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got, _ = pre1(model, prompts, c1)
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
        prefill_launches = launch_counts()
        launches.update(prefill_launches)
        tok = greedy_sample(want)[:, None]
        errs, walls, counted = [], [], None
        n_tf = 1 if dtype == "bfloat16" else gen
        for i in range(gen):
            t = SH_PROMPT + i
            if i < n_tf:     # the meshless step fed the same token
                want, _ = dec0(model, tok, c0, t)
            reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with mesh.counting() as cnt:
                got, _ = dec1(model, tok[rows], c1, t)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            launches.update(launch_counts())
            if i == 1:
                counted = cnt.collectives
            if i < n_tf:
                w = want[rows].float()
                errs.append(float((got.float() - w).abs().max())
                            / float(w.abs().max()))
                tok = greedy_sample(want)[:, None]
            else:          # greedy on the sharded logits, every rank's rows
                mine = greedy_sample(got)[:, None].contiguous()
                tok = mesh.gather(mine, (BATCH, 1), ("data", None))
        slot = c1[0][0]["self"]["k"]
        slot_bytes = slot.numel() * slot.element_size()
        a = cfg.stages[0].pattern[0].attn
        combine = 2 * slot.shape[0] * a.n_heads * (a.head_dim + 2) * 4
        tol = SH_BF16_TOL if dtype == "bfloat16" else TF_TOL
        tag = f"14b_{dtype}"
        rec[tag] = dict(errs=errs, prefill_s=t_prefill,
                        decode_ms=statistics.median(walls[1:]) * 1e3,
                        counted=counted, slot_bytes=slot_bytes,
                        slot_shape=list(slot.shape), combine_each=combine,
                        layers=layers, prefill_launches=prefill_launches,
                        peak_gib=torch.cuda.max_memory_allocated(dev)
                        / 2**30)
        if not max(errs) <= tol:
            fails.append(f"{tag} decode logits {errs} (tol {tol})")
        if slot.shape[1] * SH_MODEL != min(max_len, a.window or max_len) \
                or slot.shape[1] != c1[0][0]["self"]["pos"].shape[0] // 2:
            fails.append(f"{tag} slot block {tuple(slot.shape)}")
        ar = (counted or {}).get("all-reduce", {})
        if set(counted or {}) != {"all-reduce"} \
                or ar.get("count") != layers \
                or ar.get("bytes") != layers * combine \
                or combine >= slot_bytes:
            fails.append(f"{tag} decode step moved {counted} (combine "
                         f"{combine} B a layer, slot block {slot_bytes} B)")
        if prefill_launches.get(fa.NAME):
            fails.append(f"{tag} sharded prefill launched flash_attention "
                         f"{prefill_launches}")
        del model, c0, c1, pre0, pre1, dec0, dec1
        gc.collect()
        torch.cuda.empty_cache()
    rec["launches"].update(launches)


def _sh_prefill(rank, mesh, dev, fails, rec, cfg, tag: str) -> None:
    """14c on this rank: the sharded prefill (the whole model on every
    rank, as in 14b) against the meshless reference's logits."""
    import gc
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import forward, init_caches, init_params
    from repro_torch.models.model import (batch_rows, logits as lm_logits,
                                          seq_block)
    from repro_torch.train.data import synth_tokens
    from repro_torch.train.train_step import make_shard_ctx
    torch.cuda.reset_peak_memory_stats(dev)
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                        dev)
    shard = make_shard_ctx(mesh, BATCH)
    rows = batch_rows(shard, BATCH)
    tokens = torch.from_numpy(synth_tokens(SEED, 0, BATCH, SH_PREFILL,
                                           cfg.vocab)).to(dev)
    caches = init_caches(cfg, BATCH, SH_PREFILL, dtype=torch.float32,
                         device=dev, mesh=mesh)
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad(), mesh.counting() as cnt:
        hidden, _ = forward(model, cfg, tokens[rows], mode="prefill",
                            caches=caches, kv_block=KV_BLOCK, shard=shard,
                            return_hidden=True)
        lo, hi = seq_block(shard, SH_PREFILL)
        first = -lo % SH_STRIDE
        got = lm_logits(model, cfg, hidden[:, first::SH_STRIDE], shard)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ref = torch.load(os.path.join(rec["wdir"], f"{tag}_ref.pt"))[rows]
    ref = ref[:, (lo + first) // SH_STRIDE:][:, :got.shape[1]]
    err = float((got.float().cpu() - ref).abs().max()) \
        / float(ref.abs().max())
    rec[f"14c_{tag}"] = dict(err=err, wall_s=wall, positions=[lo, hi],
                             collectives=cnt.collectives,
                             peak_gib=torch.cuda.max_memory_allocated(dev)
                             / 2**30)
    rec["launches"].update(launch_counts())
    if not err <= TF_TOL:
        fails.append(f"14c {tag} prefill logits {err:.3e} of max|ref|")
    del model, caches, hidden, got
    gc.collect()
    torch.cuda.empty_cache()


def worker_shard(rank: int, port: int, wdir: str) -> None:
    """Phase 14 on one of 4 gloo ranks sharing the card.  A failed check
    is recorded and the rank goes on, so that no rank waits in a
    collective for one that left; the checks are raised after the
    groups are torn down."""
    import torch
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import moe_sharded
    from repro_torch.parallel import seqscan
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    join_ranks(rank, port, RANKS)
    mesh = make_local_mesh(model=SH_MODEL, device=dev)
    fails, rec = [], {"rank": rank, "wdir": wdir, "launches": Counter(),
                      "mesh": mesh.shape}
    routes = Counter()
    for mod, name in ((moe_sharded, "moe_fwd_sharded"),
                      (seqscan, "cp_vector_recurrence"),
                      (seqscan, "cp_halo")):
        def wrap(*a, _fn=getattr(mod, name), _name=name, **k):
            routes[_name] += 1
            return _fn(*a, **k)
        setattr(mod, name, wrap)
    t0 = time.time()
    _sh_train(rank, mesh, dev, fails, rec)
    rec["14a_s"] = time.time() - t0
    t0 = time.time()
    _sh_serve(rank, mesh, dev, fails, rec)
    rec["14b_s"] = time.time() - t0
    t0 = time.time()
    _sh_prefill(rank, mesh, dev, fails, rec, _sh_moe_cfg(), "mixtral")
    rec["mixtral_routes"] = dict(routes)
    routes.clear()
    _sh_prefill(rank, mesh, dev, fails, rec, _cut(RG, 3, "float32"),
                "recurrentgemma")
    rec["recurrentgemma_routes"] = dict(routes)
    rec["14c_s"] = time.time() - t0
    if not rec["mixtral_routes"].get("moe_fwd_sharded"):
        fails.append(f"14c mixtral: no moe_fwd_sharded {rec}")
    if not (rec["recurrentgemma_routes"].get("cp_vector_recurrence")
            and rec["recurrentgemma_routes"].get("cp_halo")):
        fails.append(f"14c recurrentgemma routes {rec}")
    rec["fails"] = fails
    print("SHARD " + json.dumps(rec, default=str), flush=True)
    leave_ranks(mesh)
    if fails:
        raise SystemExit("FAILED: phase 14 rank "
                         f"{rank}: " + "; ".join(fails))


def phase_sharded(dev) -> dict:
    """Phase 14 (module docstring); returns the launches of the sharded
    runs."""
    import torch
    t_phase = time.time()
    wdir = os.path.join(ROOT, "build", "phase14")
    os.makedirs(wdir, exist_ok=True)
    _sh_refs(dev, wdir)
    t0 = time.time()
    outs = spawn_ranks("--worker-shard", RANKS, wdir, timeout=SH_TIMEOUT_S)
    recs = _results(outs, "SHARD", "14")
    with open(os.path.join(wdir, "step_counts.json"), "w") as f:
        json.dump(recs[0]["14a_f32"]["steps"][-1]["collectives"], f)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[14] 4 gloo ranks on one card ({smi}), mesh {recs[0]['mesh']}, "
          f"ranks ran {time.time() - t0:.1f} s", flush=True)
    for r in recs:
        a0, f32, b16 = r["14a_step0"], r["14a_f32"], r["14a_bf16"]
        print(f"[14a] rank {r['rank']}: step 0 loss {a0['loss']:.6f} "
              f"(meshless {a0['ref']:.6f}), worst gradient block "
              f"{a0['grad_err']:.3e} of max|ref| ({a0['worst_leaf']}), "
              f"value_and_grad {a0['wall_s']:.2f} s wall, collectives "
              f"{a0['collectives']}; f32 losses {f32['losses']} (meshless "
              f"{f32['ref']}), steps "
              f"{[round(s['wall_s'], 3) for s in f32['steps']]} s wall, "
              f"step collectives {f32['steps'][-1]['collectives']}; bf16 "
              f"losses {b16['losses']}, peak {b16['peak_gib']:.2f} GiB",
              flush=True)
    print(f"[14a] rank 0 bf16 steps: {recs[0]['14a_bf16']['steps']}",
          flush=True)
    for r in recs:
        for dtype in ("bfloat16", "float32"):
            b = r[f"14b_{dtype}"]
            print(f"[14b] rank {r['rank']} {dtype} ({b['layers']} layers): "
                  f"decode logits err {max(b['errs']):.3e} of max|ref| "
                  f"over {len(b['errs'])} steps, prefill {b['prefill_s']:.2f}"
                  f" s, decode {b['decode_ms']:.1f} ms a step (median "
                  f"wall), one step counted {b['counted']} against a slot "
                  f"block {b['slot_shape']} of {b['slot_bytes']} B, "
                  f"flash_attention launches in the sharded prefill "
                  f"{b['prefill_launches'].get('flash_attention', 0)} (its "
                  f"queries are the rank's block at its global positions, "
                  f"attending to the gathered keys: not the kernel's "
                  f"function, a segment attending to itself from 0), peak "
                  f"{b['peak_gib']:.2f} GiB", flush=True)
        for tag in ("mixtral", "recurrentgemma"):
            c = r[f"14c_{tag}"]
            print(f"[14c] rank {r['rank']} {tag}: prefill logits err "
                  f"{c['err']:.3e} of max|ref| at positions {c['positions']}"
                  f", {c['wall_s']:.2f} s wall, collectives "
                  f"{c['collectives']}, routes {r[tag + '_routes']}, peak "
                  f"{c['peak_gib']:.2f} GiB", flush=True)
    launches = Counter()
    for r in recs:
        launches.update(r["launches"])
    print(f"[14] launches of the sharded runs {dict(launches)}; phase 14 "
          f"{time.time() - t_phase:.1f} s (14a {recs[0]['14a_s']:.1f}, 14b "
          f"{recs[0]['14b_s']:.1f}, 14c {recs[0]['14c_s']:.1f})", flush=True)
    torch.cuda.empty_cache()
    return dict(launches)


# --------------------------------------------------------------------------
# phase 15: the last modules (compression, the pipeline, the dry run)
# --------------------------------------------------------------------------

P15_LAYERS = 8            # 15b: 8 decoder layers, 2 a stage
P15_MICRO = 4             # 15b's microbatches
P15_BATCH = 4             # 15b's bf16 forward: 4 x 1024
P15_SEQ = 1024
P15_GRAD_SEQ = 512        # 15b's float32 gradient: 4 x 512
P15_CONS_TOL = 1e-6       # dequant(q) + res vs x + res_prev (x max|x|)
P15_PIPE_TOL = 1e-4       # tests/test_pipeline.py:53 (x max|ref| here)
P15_TIMEOUT_S = 600
P15_DRY_ARCH, P15_DRY_SHAPE = "yi-9b", "decode_32k"


def _p15_cfg(dtype: str):
    return _cut(ARCH, P15_LAYERS, dtype)


def _p15_stack(cfg, dev) -> dict:
    """The seeded model's decoder layers, each leaf stacked on a leading
    layer axis (the leaves ``model.stacked_names`` names, as the
    reference stacks them), float32."""
    import torch
    from repro_torch.models import init_params
    from repro_torch.models.model import stacked_names
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                        dev)
    names = stacked_names(model)
    by = {}
    for n, p in model.named_parameters():
        if n in names:
            by.setdefault(n.split(".", 3)[3], []).append(p.data)
    stacked = {n: torch.stack(ts) for n, ts in by.items()}
    del model
    return stacked


def _p15_layer_fn(cfg, seq: int, dev, busy=None):
    """One decoder layer through ``torch.func.functional_call`` on a
    template layer (no values of its own), in train mode at positions 0..
    seq-1; ``busy`` (a list) collects the host seconds of each call,
    synchronised on both sides."""
    import torch
    from repro_torch.models import model as model_lib
    spec = cfg.stages[0].pattern[0]
    bound = model_lib._Bound(model_lib.Layer(cfg, spec, device="meta"),
                             model_lib.layer_fwd)
    ctx = model_lib.Ctx(mode="train", q_pos=torch.arange(
        seq, dtype=torch.int32, device=dev), start=0, prefix_len=0,
        kv_block=KV_BLOCK)

    def layer_fn(p, h):
        if busy is not None:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        y = torch.func.functional_call(
            bound, {f"m.{n}": t for n, t in p.items()},
            (h, spec, cfg, ctx, None))[0]
        if busy is not None:
            torch.cuda.synchronize()
            busy.append(time.perf_counter() - t0)
        return y
    return layer_fn


def _p15_inputs(cfg, dev) -> tuple:
    """15b's seeded bf16 (4, 1024, D) and float32 (4, 512, D) inputs."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    x16 = torch.randn(P15_BATCH, P15_SEQ, cfg.d_model, generator=gen,
                      device=dev).to(torch.bfloat16)
    x32 = torch.randn(P15_BATCH, P15_GRAD_SEQ, cfg.d_model, generator=gen,
                      device=dev)
    return x16, x32


def _p15_refs(dev, wdir: str) -> None:
    """15b's sequential references on the card, saved for the ranks: the
    bf16 output, its attention computed by ``flash_attention_plain`` in
    place of the kernel (so that the pipelined forward's kernel is held
    against the plain version), and each rank's block of the float32
    gradient of sum(y^2) with every leaf's max|ref|."""
    import gc
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import attention
    t0 = time.time()
    cfg = _p15_cfg("float32")
    stacked = _p15_stack(cfg, dev)
    x16, x32 = _p15_inputs(cfg, dev)
    fn16 = _p15_layer_fn(_p15_cfg("bfloat16"), P15_SEQ, dev)
    plain_calls = []

    def plain(*a, **k):
        plain_calls.append(1)
        return fa.flash_attention_plain(*a, **k)
    kernel, attention.flash_attention = attention.flash_attention, plain
    reset_launch_counts()
    try:
        with torch.no_grad():
            h = x16
            for i in range(P15_LAYERS):
                h = fn16({n: t[i].to(torch.bfloat16)
                          for n, t in stacked.items()}, h)
    finally:
        attention.flash_attention = kernel
    torch.cuda.synchronize()
    launched = launch_counts().get("flash_attention", 0)
    print(f"[15b] sequential bf16 reference: {len(plain_calls)} plain "
          f"attention calls, {launched} kernel launches", flush=True)
    check(len(plain_calls) == P15_LAYERS and launched == 0,
          f"15b reference: {len(plain_calls)} plain calls, {launched} "
          f"kernel launches")
    torch.save(h.cpu(), os.path.join(wdir, "seq_out.pt"))
    fn32 = _p15_layer_fn(cfg, P15_GRAD_SEQ, dev)
    leaves = {n: t.requires_grad_() for n, t in stacked.items()}
    h = x32
    for i in range(P15_LAYERS):
        h = fn32({n: t[i] for n, t in leaves.items()}, h)
    grads = torch.autograd.grad((h ** 2).sum(), list(leaves.values()))
    per = P15_LAYERS // RANKS
    scale = {n: float(g.abs().max()) for n, g in zip(leaves, grads)}
    for r in range(RANKS):
        torch.save({"scale": scale, "grads": {
            n: g[per * r:per * (r + 1)].cpu()
            for n, g in zip(leaves, grads)}},
            os.path.join(wdir, f"grad{r}.pt"))
    print(f"[15b] sequential references on the card: {P15_LAYERS} layers, "
          f"bf16 {P15_BATCH} x {P15_SEQ} and float32 {P15_BATCH} x "
          f"{P15_GRAD_SEQ}; {time.time() - t0:.1f} s", flush=True)
    del stacked, leaves, grads, h
    gc.collect()
    torch.cuda.empty_cache()


def _p15_compress(rank, mesh, dev, fails, rec) -> None:
    """15a on this rank."""
    import gc
    import torch
    import torch.distributed as dist
    from repro_torch.models import init_params
    from repro_torch.parallel.compression import compressed_psum
    from repro_torch.train.data import SyntheticDataset
    from repro_torch.train.train_step import value_and_grad
    cfg = _cut(ARCH, SH_TRAIN_LAYERS, "float32")
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                        dev)
    ds = SyntheticDataset(cfg.vocab, SH_TRAIN_SEQ, BATCH, seed=SEED + rank,
                          device=dev)
    res, prev_amax, rounds = None, {}, []
    for i in range(2):
        _, _, g = value_and_grad(model, cfg, ds.batch_at(i),
                                 kv_block=KV_BLOCK)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with mesh.counting() as cnt:
            out, new = compressed_psum(g, "pod", res, mesh=mesh)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        worst_exact = worst_cons = 0.0
        f32_wall, f32 = 0.0, Counter()
        for n, x in g.items():
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            with mesh.counting() as cnt32:
                exact = mesh.all_reduce(x.clone(), "pod").wait()
            torch.cuda.synchronize()
            f32_wall += time.perf_counter() - t1
            for k, e in cnt32.collectives["all-reduce"].items():
                f32[k] += e
            xf = x if res is None else x + res[n]
            amax = mesh.all_reduce(xf.abs().max().reshape(1), "pod",
                                   op=dist.ReduceOp.MAX).wait()[0]
            scale = torch.where(amax > 0, amax / 127.0, 1.0)
            q = torch.clamp(torch.round(xf / scale), -127, 127)
            top = max(float(amax), prev_amax.get(n, 0.0))
            prev_amax[n] = float(amax)
            e = float((out[n] - exact).abs().max())
            worst_exact = max(worst_exact, e / max(4 * top / 127, 1e-30))
            c = float((q * scale + new[n] - xf).abs().max())
            worst_cons = max(worst_cons, c / max(
                float(x.abs().max()), 1e-30))
            del exact, xf, q
        rounds.append(dict(collectives=cnt.collectives, wall_s=wall,
                           f32_collectives={"all-reduce": dict(f32)},
                           f32_wall_s=f32_wall, exact_share=worst_exact,
                           cons_share=worst_cons, leaves=len(g)))
        if not worst_exact <= 1.0:
            fails.append(f"15a round {i}: {worst_exact:.3f} of 4·amax/127")
        if not worst_cons <= P15_CONS_TOL:
            fails.append(f"15a round {i}: dequant(q) + res off x + res_prev "
                         f"by {worst_cons:.3e} of max|x|")
        res = new
        del g, out
    rec["15a"] = rounds
    del model, res, new
    gc.collect()
    torch.cuda.empty_cache()


def _p15_pipeline(rank, mesh, dev, fails, rec) -> None:
    """15b on this rank."""
    import gc
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.parallel.pipeline import bubble_fraction, pipeline_apply
    wdir = rec["wdir"]
    cfg32 = _p15_cfg("float32")
    stage = mesh.axis_index("pod")
    per = P15_LAYERS // RANKS
    mine = slice(per * stage, per * (stage + 1))
    # the stage keeps only its own layers: the seeded stack is made whole
    # (the sequential reference's values) and all but this block freed
    stacked = _p15_stack(cfg32, dev)
    whole = sum(t.numel() * t.element_size() for t in stacked.values())
    block = {n: t[mine].clone() for n, t in stacked.items()}
    del stacked
    gc.collect()
    torch.cuda.empty_cache()
    x16, x32 = _p15_inputs(cfg32, dev)
    busy = []
    fn16 = _p15_layer_fn(_p15_cfg("bfloat16"), P15_SEQ, dev, busy)
    s16 = {n: t.to(torch.bfloat16) for n, t in block.items()}
    with torch.no_grad():      # one untimed pass: every stage warm
        pipeline_apply(fn16, s16, x16, mesh=mesh, stage_axis="pod",
                       n_micro=P15_MICRO, local=True)
    busy.clear()
    reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with torch.no_grad(), mesh.counting() as cnt:
        y = pipeline_apply(fn16, s16, x16, mesh=mesh, stage_axis="pod",
                           n_micro=P15_MICRO, local=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak16 = torch.cuda.max_memory_allocated(dev)
    launches = Counter(launch_counts())
    want = torch.load(os.path.join(wdir, "seq_out.pt")).to(dev).float()
    err = float((y.float() - want).abs().max()) / float(want.abs().max())
    del s16, y, want
    rec["15b_fwd"] = dict(stage=stage, launches=dict(launches), wall_s=wall,
                          busy_s=sum(busy), calls=len(busy),
                          idle_share=1.0 - sum(busy) / wall,
                          bubble=bubble_fraction(RANKS, P15_MICRO),
                          err=err, collectives=cnt.collectives,
                          peak_gib=peak16 / 2**30,
                          whole_gib=whole / 2 / 2**30)
    rec["launches"].update(launches)
    if not err <= BF16_TF_TOL:
        fails.append(f"15b stage {stage}: output {err:.3e} of max|ref|")
    if launches.get("flash_attention", 0) != per * P15_MICRO:
        fails.append(f"15b stage {stage}: flash_attention launches "
                     f"{dict(launches)}, want {per * P15_MICRO}")
    # the float32 gradient of sum(y^2) with respect to the stage's block
    fn32 = _p15_layer_fn(cfg32, P15_GRAD_SEQ, dev)
    leaves = {n: t.requires_grad_() for n, t in block.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    y = pipeline_apply(fn32, leaves, x32, mesh=mesh, stage_axis="pod",
                       n_micro=P15_MICRO, local=True)
    loss = (y ** 2).sum()
    # the gradient is the mean of the ranks' losses': all must be equal
    hi, lo = (float(mesh.all_reduce(loss.detach().reshape(1), "pod",
                                    op=op).wait()[0])
              for op in (dist.ReduceOp.MAX, dist.ReduceOp.MIN))
    loss.backward()
    torch.cuda.synchronize()
    gwall = time.perf_counter() - t0
    peak32 = torch.cuda.max_memory_allocated(dev)
    ref = torch.load(os.path.join(wdir, f"grad{rank}.pt"))
    worst, leaf = 0.0, None
    for n, t in leaves.items():
        e = float((t.grad.cpu() - ref["grads"][n]).abs().max()) / max(
            ref["scale"][n], 1e-30)
        if e > worst:
            worst, leaf = e, n
    rec["15b_grad"] = dict(err=worst, leaf=leaf, wall_s=gwall,
                           loss_spread=hi - lo, peak_gib=peak32 / 2**30,
                           whole_gib=whole / 2**30)
    if not worst <= P15_PIPE_TOL:
        fails.append(f"15b stage {stage}: gradient {leaf} {worst:.3e} of "
                     f"max|ref|")
    if hi != lo:
        fails.append(f"15b stage {stage}: the ranks' losses differ by "
                     f"{hi - lo}")
    del block, leaves, y, ref, x16, x32
    gc.collect()
    torch.cuda.empty_cache()


def worker_last(rank: int, port: int, wdir: str) -> None:
    """15a and 15b on one of 4 gloo ranks sharing the card; a failed
    check is recorded and raised after the groups are torn down."""
    import torch
    from repro_torch.core import make_mesh
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    join_ranks(rank, port, RANKS)
    mesh = make_mesh((RANKS,), ("pod",), device=dev)
    fails, rec = [], {"rank": rank, "wdir": wdir, "launches": Counter()}
    t0 = time.time()
    _p15_compress(rank, mesh, dev, fails, rec)
    rec["15a_s"] = time.time() - t0
    t0 = time.time()
    _p15_pipeline(rank, mesh, dev, fails, rec)
    rec["15b_s"] = time.time() - t0
    rec["fails"] = fails
    print("LAST " + json.dumps(rec, default=str), flush=True)
    leave_ranks(mesh)
    if fails:
        raise SystemExit("FAILED: phase 15 rank "
                         f"{rank}: " + "; ".join(fails))


def dryrun_cells() -> None:
    """15c, in a process of its own (it joins fake process groups): the
    FFT cell, the fake count of 14a's step, and one production LM cell;
    prints one DRY JSON line.  Touches no card."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_local_mesh
    rec = {}
    t0 = time.time()
    rec["fft"] = dryrun.lower_fft_cell("fft_1024", False)
    rec["fft"]["wall_s"] = time.time() - t0
    t0 = time.time()
    with dryrun.fake_world(RANKS):
        mesh = make_local_mesh(model=SH_MODEL, device="cpu")
        got = dryrun.count_lm_step(
            _cut(ARCH, SH_TRAIN_LAYERS, "float32"),
            ShapeSpec("14a", "train", SH_TRAIN_SEQ, BATCH), mesh, KV_BLOCK,
            {"moment_dtype": "float32"})
        mesh.close()
    rec["14a"] = dict(collectives=got["collectives"],
                      count_s=got["count_s"], wall_s=time.time() - t0)
    t0 = time.time()
    rec["lm"] = dryrun.lower_lm_cell(P15_DRY_ARCH, P15_DRY_SHAPE, False)
    rec["lm"]["wall_s"] = time.time() - t0
    print("DRY " + json.dumps(rec), flush=True)


def phase_last_modules(dev) -> dict:
    """Phase 15 (module docstring); returns the launches of 15b's
    pipelined forward."""
    import torch
    t_phase = time.time()
    wdir = os.path.join(ROOT, "build", "phase15")
    os.makedirs(wdir, exist_ok=True)
    dry = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                            "--dryrun"], stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
    try:
        _p15_refs(dev, wdir)
        t0 = time.time()
        outs = spawn_ranks("--worker-last", RANKS, wdir,
                           timeout=P15_TIMEOUT_S)
        t_ranks = time.time() - t0
        t0 = time.time()
        dout, _ = dry.communicate(timeout=P15_TIMEOUT_S)
        t_wait = time.time() - t0
    finally:
        if dry.poll() is None:
            dry.kill()
            dry.wait()
    recs = _results(outs, "LAST", "15")
    if dry.returncode:
        print(dout[-4000:], file=sys.stderr)
    check(dry.returncode == 0, f"15c dry run exited {dry.returncode}")
    drec = _results([dout], "DRY", "15c")[0]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[15] 4 gloo ranks on one card ({smi}), a pod axis of 4, ranks "
          f"ran {t_ranks:.1f} s; gloo's wire and host copies are gloo's, "
          f"not the card's", flush=True)
    for r in recs:
        for i, a in enumerate(r["15a"]):
            print(f"[15a] rank {r['rank']} round {i}: {a['leaves']} leaves, "
                  f"compressed_psum counted {a['collectives']} in "
                  f"{a['wall_s']:.3f} s wall, the float32 all-reduce "
                  f"{a['f32_collectives']} in {a['f32_wall_s']:.3f} s; worst "
                  f"leaf {a['exact_share']:.3f} of 4·amax/127 from the exact "
                  f"sum, dequant(q) + res off x + res_prev by "
                  f"{a['cons_share']:.3e} of max|x|", flush=True)
    for r in recs:
        b, g = r["15b_fwd"], r["15b_grad"]
        print(f"[15b] stage {b['stage']}: launches {b['launches']}, "
              f"output err {b['err']:.3e} of max|ref|, wall "
              f"{b['wall_s'] * 1e3:.1f} ms, busy {b['busy_s'] * 1e3:.1f} ms "
              f"in {b['calls']} layer calls, idle share "
              f"{b['idle_share']:.3f} (bubble fraction {b['bubble']:.4f}), "
              f"collectives {b['collectives']}, peak {b['peak_gib']:.2f} "
              f"GiB (the whole bf16 stack {b['whole_gib']:.2f} GiB); "
              f"float32 gradient {g['err']:.3e} of max|ref| ({g['leaf']}), "
              f"losses' spread {g['loss_spread']}, forward+backward "
              f"{g['wall_s']:.2f} s wall, peak {g['peak_gib']:.2f} GiB (the "
              f"whole float32 stack {g['whole_gib']:.2f} GiB)", flush=True)
    launches = Counter()
    for r in recs:
        launches.update(r["launches"])
    want = P15_LAYERS * P15_MICRO
    check(launches.get("flash_attention", 0) == want,
          f"15b flash_attention launches {dict(launches)}, want {want}")
    # 15c
    fft, lm = drec["fft"], drec["lm"]
    print(f"[15c] dry run in its own process, on the CPU, waited "
          f"{t_wait:.1f} s after the ranks: fft_1024 pencil on 16x16 "
          f"{fft.get('status')} {fft.get('collectives')} against "
          f"comm_model_bytes {fft.get('comm_model_bytes')} "
          f"({fft['wall_s']:.1f} s)", flush=True)
    check(fft.get("status") == "ok" and fft["collectives"] == {
        "all-to-all": {"count": 8, "bytes": int(fft["comm_model_bytes"])}},
        f"15c fft_1024 cell {fft}")
    with open(os.path.join(ROOT, "build", "phase14",
                           "step_counts.json")) as f:
        real = json.load(f)
    fake = drec["14a"]
    print(f"[15c] 14a's float32 step on a fake (2, 2) world: "
          f"{fake['collectives']} in {fake['count_s']:.1f} s; 14a's rank 0 "
          f"counted {real}", flush=True)
    check(fake["collectives"] == real,
          f"15c fake count {fake['collectives']} != 14a's {real}")
    print(f"[15c] {P15_DRY_ARCH} {P15_DRY_SHAPE} on 16x16: "
          f"{lm.get('status')}, count_s {lm.get('count_s')} "
          f"({lm['wall_s']:.1f} s wall), roofline {lm.get('roofline')}, "
          f"collectives {lm.get('collectives')}, memory {lm.get('memory')}",
          flush=True)
    check(lm.get("status") == "ok", f"15c {P15_DRY_ARCH} cell: "
          f"{lm.get('error')}")
    check(lm["roofline"].get("bytes_source") == "arguments+outputs",
          f"15c {P15_DRY_ARCH} roofline {lm['roofline']}")
    print(f"[15] launches {dict(launches)}; phase 15 "
          f"{time.time() - t_phase:.1f} s (15a {recs[0]['15a_s']:.1f}, 15b "
          f"{recs[0]['15b_s']:.1f})", flush=True)
    torch.cuda.empty_cache()
    return dict(launches)


def run_phases(names) -> int:
    """Build the kernels and run only the named phases, in order
    (``phase_<name>(dev)``; ``last_modules`` reads what ``sharded``
    wrote): a quicker check of one path.  Prints no result line."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    dev = torch.device("cuda", 0)
    _build.build_all()
    for name in names:
        t0 = time.time()
        got = globals()["phase_" + name](dev)
        print(f"[only] {name}: {got} in {time.time() - t0:.1f} s",
              flush=True)
    return 0


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    dev = torch.device("cuda", 0)
    t0 = time.time()
    for name, log in _build.build_all().items():
        usage = [l.strip() for l in log.splitlines()
                 if "registers" in l or "spill" in l]
        print(f"[0] built {name}: " + " | ".join(usage), flush=True)
    print(f"[0] build {time.time() - t0:.1f} s", flush=True)

    timings = phase_kernels(dev)
    dft, default_counts = phase_dft_rows(dev)
    timings.update(dft)
    timings.update(phase_rotate_shapes(dev))
    phase_rotate_rank_blocks(dev)
    timings.update(phase_real_kernels(dev))
    timings.update(phase_attention_kernel(dev))
    phase_host_overhead(dev)
    # each path's launches, by the phase function that drove it
    paths = [("default_plan", default_counts), ("full", phase_full(dev)),
             ("real_full", phase_real_full(dev))]
    paths += [(f"distributed.{i}", c)
              for i, c in enumerate(phase_distributed())]
    paths += [("cell", phase_cell()), ("serve", phase_serve(dev)),
              ("grad", phase_grad(dev)), ("tune", phase_tune(dev)),
              ("service", phase_service(dev))]
    trace_counts, trace_results = phase_trace()
    moe_counts, scan_results = phase_moe(dev)
    paths += [("trace", trace_counts),
              ("fnet", phase_fnet(dev, trace_results)), ("moe", moe_counts),
              ("lm_archs", phase_lm_archs(dev, scan_results)),
              ("frontends", phase_frontends(dev)), ("train", phase_train(dev)),
              ("sharded", phase_sharded(dev)),
              ("last_modules", phase_last_modules(dev))]
    print("[16] launches by path: " + json.dumps(dict(paths), default=str),
          flush=True)

    # name -> (source in csrc/, the TPU kernel's pallas_call it replaces)
    ported = {
        "fft4step": ("fft4step", "src/repro/kernels/fft_matmul.py:107"),
        # no pallas_call: the reference leaves these products to XLA
        "dft_rows": ("dft_rows", None),
        "rotate_blocks": ("rotate_blocks",
                          "src/repro/kernels/transpose_pack.py:84"),
        "unpack_two_for_one": ("hermitian",
                               "src/repro/kernels/hermitian.py:83"),
        "hermitian_extend": ("hermitian",
                             "src/repro/kernels/hermitian.py:122"),
        "spectral_scale": ("spectral_scale",
                           "src/repro/kernels/spectral_scale.py:41"),
        "spectral_scale_full": ("spectral_scale",
                                "src/repro/kernels/spectral_scale.py:74"),
        # no pallas_call: the reference builds the Poisson multiplier at
        # full shape and runs spectral_scale_full
        "spectral_scale_poisson": ("spectral_scale", None),
        "flash_attention": ("flash_attention",
                            "src/repro/kernels/flash_attention.py:95"),
    }
    kernels = []
    for name, (src, replaces) in ported.items():
        t = timings[name]
        launches = sum(p.get(name, 0) for _, p in paths)
        check(launches > 0, f"{name} not launched on the main path")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            **{k: t[k] for k in ("dense_bound_ms", "dense_bound_by")
               if k in t}})
    print(json.dumps({"kernels": kernels}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--worker":
        worker(int(sys.argv[2]), int(sys.argv[3]))
        sys.exit(0)
    if len(sys.argv) == 4 and sys.argv[1] == "--worker-cell":
        worker_cell(int(sys.argv[2]), int(sys.argv[3]))
        sys.exit(0)
    if len(sys.argv) == 5 and sys.argv[1] == "--worker-tune":
        worker_tune(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        sys.exit(0)
    if len(sys.argv) == 5 and sys.argv[1] == "--worker-trace":
        worker_trace(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        sys.exit(0)
    if len(sys.argv) == 4 and sys.argv[1] == "--worker-moe":
        worker_moe(int(sys.argv[2]), int(sys.argv[3]))
        sys.exit(0)
    if len(sys.argv) == 5 and sys.argv[1] == "--worker-service":
        worker_service(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        sys.exit(0)
    if len(sys.argv) == 5 and sys.argv[1] == "--worker-shard":
        worker_shard(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        sys.exit(0)
    if len(sys.argv) == 5 and sys.argv[1] == "--worker-last":
        worker_last(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        sys.exit(0)
    if len(sys.argv) == 2 and sys.argv[1] == "--dryrun":
        dryrun_cells()
        sys.exit(0)
    if len(sys.argv) > 2 and sys.argv[1] == "--phases":
        sys.exit(run_phases(sys.argv[2:]))
    sys.exit(main())
