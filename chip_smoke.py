"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, each printed as it ends:

1. card: the card's name and power limit, then all four kernel libraries'
   builds and those of the variants (``VARIANTS``), started together
   (``nvcc`` for ``sm_90a``, one per source, from the sources in the
   checkout), and the counts of ``HGMMA`` (``wgmma``)
   instructions in the flash library's SASS and of ``HMMA`` (``mma.sync``)
   in the SSD library's, each of which must be above 0;
2. the BSR kernels against their plain PyTorch versions on the card, at the
   FSI path's shapes and data (GraphChallenge N = 65536, batch 128, 32x32
   blocks; the fleet of P = 64 workers that ``run_fsi`` stacks), at one
   layer of each block pattern: layer 0 (dense blocks, K 1), layer 1 (4
   nonzeros a block row, K 8) and layer 2 (1 nonzero a block row, K 32),
   plus a ragged batch and a zero-count worker; tolerance 1e-5 (summation
   order); the fleet kernel must equal the per-worker kernel bit for bit;
   both kernels are timed at each of the three layers beside their plain
   versions, a ``torch.sparse_bsr_tensor`` product and the bound, which
   counts one FMA a nonzero weight (``ops.layer_work``), and against
   builds of their source with a one-stage ring and without the non-finite
   test; at each layer both are also held to their plain versions on x
   with Inf, -Inf and NaN in column blocks >= 1 (NaN in the same places,
   the rest at 1e-5);
3. the FSI path: ``run_fsi`` with the ``torch-bsr`` backend on the queue and
   object channels at P = 64 and on the serial channel, on an 8-layer cut of
   the N = 65536 GraphChallenge net; each output is held to 1e-4 of
   ``dense_inference``, and FLOPs, messages and raw exchange bytes to exact
   equality with a ``numpy-fast`` run (cost within 5%);
4. the split-KV decode kernel against its plain version on the card: the
   serving path's shape (B 8, H 16, KV 8, D 128, S 640) in bf16 (2e-2) and
   fp32 (1e-5) at cache lengths 0, 1, 63, 64, 65, 544 and 640 and one key
   either side of every split's first and last key (the kernel splits the
   cache across blocks); G = 1 and G = 4 at D 64; the kernel's paged form
   (``ops.decode_mha_paged``: K and V in shuffled pages of one layer of a
   two-layer buffer, read through a block table) at the serving shape in
   pages of 128 (bf16 and fp32) and at the benchmark cell's (B 128, S 1536,
   pages of 256, bf16), against the plain version (2e-2, 1e-5) and bit for
   bit the contiguous kernel over the gathered copy at 0, 1, each page's
   edges +-1 and the capacity and with one length a row, then both forms
   timed from a CUDA graph beside their bytes bound (``[time]
   decode_attention_paged`` lines); one long-cache layer
   (B 32, KV 8, S 32768, D 128, bf16);
5. the serving path: ``ServingEngine(get_config("internlm2-1.8b"))`` at
   full width (24 layers, bf16 params drawn on the card from seed 0,
   ``torch-splitk``) generates 32 tokens for 8 prompts of 512 tokens; every
   layer of every step must launch the decode kernel; then, teacher-forced
   on those tokens, the kernel's plain version run as a backend on the card
   must give every step's logits within 3e-2 on all but 1% of them, and
   90% of the same greedy next tokens (the reference's plain backends
   ``dense-ref`` and ``chunked-lse``, which round the probabilities to
   bf16 at other points, are measured beside it); and
   ``torch-splitk`` and ``dense-ref`` on fp32 copies of the params must give
   identical greedy tokens and logits within 1e-4;
5b. continuous batching (``serving/scheduler.py`` over the paged KV pool of
   ``serving/kv_pool.py``): the decode kernel with one cache length per
   batch row (0, 1, 63, 64, 65, 544, 640, 513, and reversed) at the
   serving shape against its plain version (bf16 2e-2, fp32 1e-5), each
   row bit for bit the launch of its own length; then a ragged stream at
   internlm2-1.8b's full width (16 requests, prompts 64-512, budgets 8-64,
   arrivals over 24 steps, 8 slots of capacity 640) through the step
   captured in one CUDA graph: 24 x steps_run decode-kernel launches in
   ``torch.profiler``'s trace of the whole graphed stream (a replay does
   not pass through the wrapper, which counts the warm-up's and the
   capture's launches; the eager stream's it counts, 24 x steps_run),
   one capture over all its streams (a trace short of the count, as the
   profiler has once lost 9 of its events, is taken again, up to three
   times), one prefill graph a prompt-length bucket and one replay an
   admission, the same stream eager (the same padded prefill) bit for bit
   equal, ms a step (between CUDA events) and the decode steps'
   tokens/s graphed and eager, no step gathering the pool
   (``gather_steps`` 0: the step reads the pages through the block
   table, every launch the kernel's paged form), and slot-steps against
   padded static batching; the padded prefill's graphs at the
   benchmark cell's capacity 1536 (all eight buckets): a stream of
   prompts of 8-512 tokens graphed against eager bit for bit, each prompt's
   padded prefill teacher-forced against the unpadded one (<= 1% of the
   logits outside 3e-2, >= 90% of first tokens equal), 4 requests bit
   for bit themselves alone, and ``[time]`` lines for an admission of 43
   and of 512 tokens graphed and eager; then 4 of the requests with
   fp32 params, each bit for bit itself served alone through the same
   scheduler, and with the tokens of ``generate`` at B 1 (logits within
   1e-4); mamba2-370m's shorter stream runs in phase 7 (graphed, no
   hand-written kernel, each request bit for bit itself alone, = eager);
6. the flash-attention prefill kernel (its path is its entry point
   ``kernels/flash_attention/ops.py::mha``, which no model calls, as in the
   reference): against its plain version at the reference's test shapes
   (both dtypes, non-causal with Sq 128 / Sk 256, block-shape invariance),
   at internlm2-1.8b's prefill shape (B 8, H 16, KV 8, S 512, D 128,
   causal, bf16 and fp32) and at one long shape (B 1, S 8192, bf16); bf16
   inputs run the tensor-core kernel, fp32 the scalar one;
   tolerances 1e-5 fp32, 2e-2 bf16, and bf16 outputs also at rtol 8e-3,
   atol 1e-4 against the plain version on fp32-widened inputs;
7. mamba2-370m at full width (48 layers, d_model 1024, bf16 params drawn on
   the card from seed 0): the chunked SSD scan kernel (its path is
   ``kernels/ssd_scan/ops.py::ssd``) against its plain version at the
   reference's test shapes and one with G 3 of H 6 and chunks of 96 (both
   dtypes; y at 1e-5 / 2e-2, bf16 y also as flash's is, the state at 5x,
   and the bf16 state at 1e-4 of the plain version, which widens to fp32)
   and its sequential-recurrence state check (1e-4), at the model's
   prefill shape fed layer 0's real inputs for the served prompts (B 8,
   H 32, G 1, L 512, P 64, N 128, chunk 256, bf16) and at one long shape
   (B 1, L 16384); a build with ``split3`` cut to one piece must fail the
   bf16 state and share checks at the G 3 shape and both path shapes; the
   two path shapes are timed by call, from a CUDA graph and by launch
   (device time and grid from ``torch.profiler``'s trace), and each of the
   four launches at the long shape must have at least 132 blocks; then
   ``ServingEngine(get_config("mamba2-370m"))`` generates
   32 tokens for 8 prompts of 512 (the path launches none of the
   hand-written kernels, as in the reference), is profiled, and in fp32 on
   the card picks the tokens the same engine picks on the CPU (batch 2,
   prompt 256, 4 new tokens; logits within 1e-4); and its shorter
   continuous-batching stream (8 requests, prompts 64-256, budgets 4-16, 4
   slots), as in 5b;
8. the LM pipeline over the serverless fabric (``run_lm_pipeline``) at
   internlm2-1.8b's full width (bf16 params drawn on the card from seed 0,
   ``torch-splitk``): P 4 stages of 6 layers, batch 8, prompts of 128 and
   16 new tokens from ``np.random.default_rng(0)``, on the queue and the
   object channel, each with the overlap and the phased clock: tokens and
   logits bit for bit a ``ServingEngine(engine="device")`` run on the same
   params and prompts, every billed count equal between the two clocks,
   24 x 16 decode-kernel launches a run (counted by the wrapper) and each
   stage's cache 6 layers deep; each run's host wall, split into stage
   compute (between CUDA events around each stage's call) and host time
   (packing, zlib, drains, the simulator), makespan, cost and message
   counts;
9. deepseek-moe-16b at full width (28 layers, d_model 2048, 64 routed
   experts of 1408 and 2 shared, top-6; bf16 params drawn on the card from
   seed 0; fp32 KV cache): ``ServingEngine.generate`` for 8 prompts of 512
   with 32 new tokens, 28 x 32 = 896 decode-kernel launches (fp32, G 1),
   prefill and decode times, tokens/s, peak memory and a profile of 4
   steps; the decode kernel at its shape (B 8, H 16, KV 16, D 128, S 640)
   with a bf16 q that the backend widens, against its plain version at
   cache lengths 0, 1, 513 and 544 (1e-5; the bf16 output the fp32
   kernel's rounded once, bit for bit), timed beside its bound and SDPA;
   teacher-forced on the 32 tokens against the kernel's plain version as a
   backend (the share of logits outside 3e-2, >= 90% of greedy next tokens
   equal, the share of (token, layer) pairs whose top-6 experts agree);
   the pipeline at P 4 on the queue (batch 4, prompts of 128, 8 new), bit
   for bit the device engine's; a stream of 6 requests through 4 slots,
   graphed = eager bit for bit and each request bit for bit itself alone;
   and a depth cut to 4 layers (1 dense, 3 moe) in fp32 at full width,
   whose tokens on the card are the CPU's (logits within 1e-4);
10-12. zamba2-7b (hybrid: 81 mamba2 blocks and one shared attention block
   at 14 sites, d_head 112), seamless-m4t-medium (encdec: 12 encoder and
   12 decoder layers over 1024 source frames) and internvl2-2b (vlm: 256
   image embeddings before the prompt) at full width, bf16 params drawn
   on the card from seed 0, frames and embeddings normal from the seed
   (``family_phase``, ``FAMILY_PHASES``): ``generate`` for 8 prompts of
   512, 128 and 256 with 32 new tokens, its decode-kernel launches (14,
   24 = 12 self + 12 cross, and 24 a step), prefill and step times,
   tokens/s, peak memory and a profile of 4 steps; the decode kernel at
   the path's shapes held to its plain version in bf16 and fp32 at every
   split's edges (zamba2's sites B 8, H 32, KV 32, D 112, S 640, timed in
   both dtypes; seamless's self cache, and its cross cache B 8, H 16, KV
   16, D 64, S 1024, timed in bf16; internvl2's at phase 4's shape), timed
   beside its bound and SDPA; teacher-forced on the 32 tokens against the
   kernel's plain version, every kernel call held to the plain version on
   its own inputs (2e-2), the plain version stepping from the kernel run's
   cache (pinned) and from its own (free), ``dense-ref`` free beside them:
   seamless's held to the dense gate (<= 1% of a step's logits outside
   3e-2, >= 90% of next tokens equal), zamba2's and internvl2's pinned
   next tokens to >= 90% and their logits reported; a stream of 6 requests
   (each with its frontend input) through 4 slots, graphed = eager bit for
   bit and each request bit for bit itself alone; internvl2's pipeline at
   P 4 with the embeddings as ``extra`` (batch 4, prompts of 128, 8 new)
   on the queue and the object channel with both clocks, bit for bit the
   device engine's; fp32 copies at full depth, ``torch-splitk`` against
   ``dense-ref`` (identical tokens, logits 1e-4); and an fp32 depth cut at
   full width (7 layers, 2 sites; 2 + 2 layers; 2 layers), the card
   against the CPU (B 2, prompt 64, 8 new: identical tokens, 1e-4);
13. ``run_fsi`` over the sharded fleet backend (``torch-bsr-sharded``) on
   phase 3's net, inputs and partition (``SHARDED_RUNS``): the queue
   channel with one shard fused (8 fleet launches) and vmap (512 per-worker
   launches, 64 a layer), and the object channel over ``[cuda:0] * 3``
   fused (P 64 padded to 66, 24 fleet launches); each output bit for bit
   phase 3's ``torch-bsr`` output on its channel and within 1e-4 of
   ``dense_inference``, FLOPs, messages and raw bytes exactly
   ``numpy-fast``'s, cost within 5%; each run's host wall beside
   ``torch-bsr``'s (``[run_fsi] sharded`` lines);
14. training internlm2-1.8b at full width through ``Trainer.fit`` (AdamW,
   remat on): whether ``mm(bf16, out_dtype=fp32)`` has a derivative on this
   torch (the port does not rely on it); (a) bf16, 24 layers, 8 steps of
   8 x 512 tokens: finite losses, the first within 2% of a random init's
   expected loss (ln of the padded vocabulary plus half the logits'
   variance, 0.02^2 x d_model), every later loss below the first, ms a
   step between CUDA events (the median of the 6 steps that are neither
   the warm-up nor the profiled one), tokens/s, the bound of the weight
   products, peak memory, the busy share of one step from
   ``torch.profiler``; (b) at a 2-layer cut at full width, batch 2 x 128,
   the card against the CPU: in fp32 the loss within 1e-5 relative, every
   gradient leaf within 1e-4 of its largest magnitude, AdamW's update
   given the CPU's gradients within 1e-6; in bf16 (the card's products
   differentiated by ``layers._ProductAcc``, the CPU's by autograd through
   the widened operands) the loss within 2^-8 relative and every gradient
   leaf, bf16 on both sides, within 2e-2 of its largest magnitude, and a
   control whose square weights' cotangents are transposed refused by
   that gate; (c) bf16 at the cut, batch 8 x 512, under
   ``torch.use_deterministic_algorithms``: 4 steps uninterrupted against
   a run stopped after 2 (checkpoint at 2 in a temporary directory) and
   resumed to 4: params, AdamW's m, v and step, and the losses bit for
   bit (``[train]`` lines);
15. the sequence-sharded stream (``generate_stream(mesh=...)``'s step,
   ``stream_mesh_phase``), run after 5b: internlm2-1.8b at full width and
   depth, bf16, phase 5b's 16 requests through 8 slots of capacity 1024
   (``MESH_CAP``: 4 shards of two 128-key blocks) over ``make_mesh((D,),
   ("seq",), [cuda:0] * D)`` for D 1, 2 and 4, each step captured in one
   CUDA graph: D 1 bit for bit the unsharded graphed stream (tokens and
   final logits); at the op level ``sharded_decode_attend`` on layer 0's
   real q, K and V (rows at positions either side of every shard edge)
   against the unsharded kernel call at D 2 and 4, 1e-5 in fp32 and 2e-2
   in bf16, the token written on its owner only, each shard's launch held
   to the plain version at the shard's shape; the lse merge timed; the
   dense serving gate at D 2 and 4, teacher-forced on ``generate``'s
   tokens at the mesh capacity (>= 90% of greedy next tokens equal to
   the unsharded step's; logits outside 3e-2 reported); D 2 and D 4's
   free-running share of stream tokens equal to the unsharded stream's,
   reported (one early flip carries through its request); at D 4
   graph = eager bit for bit, 24 x 4 decode kernels a step (the profiler's
   trace of the graphed stream, the wrapper's count of the eager one),
   each request bit for bit itself served alone through the same
   scheduler; an fp32 depth cut (4 layers, full width, 4 requests): at
   every D tokens identical to the unsharded stream's, logits within 1e-4
   (``[stream-mesh]`` lines: ms a step graphed and eager, tokens/s);
16. expert parallelism (``ep_phase``), run inside phase 9 on its engine:
   deepseek-moe-16b with ``set_shard_ctx`` over a ``(1, 4)`` ``("data",
   "model")`` mesh of ``[cuda:0] * 4`` and ``set_moe_ep_shardmap(True)``:
   the first moe layer at its real inputs (one 512-token prefill, phase
   9's first decode step) against ``moe_ffn``, bf16 at 2e-2 and widened
   to fp32 within 1e-5 of the largest |out| with every shard routing every
   token to ``moe_ffn``'s experts; ``generate`` with EP on against EP off:
   peak memory within 2 GB (the shards' experts are views of the stacks),
   teacher-forced on EP off's tokens pinned to its experts >= 90% of next
   tokens equal, free-running and expert-set agreement reported; the
   sequence-sharded stream at D 2 over deepseek (6 requests, 4 slots,
   capacity 256): graph = eager bit for bit (``[ep]``, ``[stream-mesh]``
   lines); and, after phase 3, ``sparse_layer_apply`` on the card (an
   offline ``BSRMatrix`` through the ``bsr_spmm`` kernel, one launch)
   against the kernel's plain version at 1e-5;
17. the dry run (``dryrun_phase``; ``[dryrun]`` lines): the card's name
   picks its data-sheet constants (``core/cost_model.accelerator_for``),
   whose ``hbm_bytes`` must be within 1% of the card's total memory; the
   reference's two gate cells, ``llama3.2-1b x train_4k`` and
   ``internlm2-1.8b x decode_32k`` on the ``(16, 16)`` production mesh of
   ``meta`` devices, must be ``ok``; two cells on a ``(1, 1)`` meta mesh
   at the shapes the card ran: phase 14's training step (internlm2-1.8b,
   8 x 512, bf16, AdamW, remat), whose argument bytes must equal the
   bytes of the params, AdamW state and batch phase 14 held, summed from
   those tensors, and phase 5's decode step (B 8, cache 640); their
   roofline terms beside phase 14's measured step and phase 5's measured
   ms a step, with the ratios (reported, not gated); the route
   (``route_accelerator``) of the example's three archs at ``decode_32k``;
   the card's allocated memory the same before and after (the dry run
   allocates nothing); the phase within 30 s;
18. real tensors on placements (``placement_phase``; ``[placement]``
   lines), on phase 14 (c)'s checkpoint of the bf16 2-layer cut with
   AdamW's state: ``checkpoint.restore(..., shardings=)`` onto the
   reference's ``(2, 4)`` ``("data", "model")`` mesh over ``[cuda:0] * 8``
   (``param_pspecs``, FSDP off, and ``AdamW.state_pspecs``), every shard
   bit for bit the same mesh position's of the restore onto ``["cpu"] *
   8``, ``gather`` of every leaf bit for bit the unsharded restore, at
   least one leaf split (seconds, bytes copied to the card, peak memory
   logged); ``device_batch(shardings=)`` of the 8 x 512 batch on that
   mesh, each shard its slice of ``batch(step)``; ``compressed_psum`` over
   ``[cuda:0] * 4`` of the cut's fp32 gradient leaves from four batches,
   bit for bit the CPU's on the same shards and within ``8 x scale`` of
   the fp32 sum (ms a call on the largest leaf, int8 and fp32 wire
   bytes); the phase within 60 s;
19. one JSON line with each kernel's time, launches on its path, bound,
   plain-version time and one library call's time (the BSR kernels' at
   layer 2, and at each timed layer under ``by_layer``; the decode
   kernel's launches on the graphed stream, counted in the profiler's
   trace, under ``stream_launches`` and the stream's numbers under
   ``stream``; its launches on phase 8's pipeline run under
   ``pipeline_launches`` and in phase 9's ``generate`` under
   ``moe_generate_launches``, its times at deepseek's shape under
   ``moe_decode_shape``; phases 10-12's under ``hybrid_generate_launches``,
   ``encdec_generate_launches`` and ``vlm_generate_launches``, their times
   at the path shapes under ``hybrid_decode_shapes`` (D 112) and
   ``encdec_decode_shapes`` (the cross cache), and each phase's numbers
   under ``hybrid``, ``encdec`` and ``vlm``; the BSR kernels' launches in
   phase 13's runs, with each run's host wall, under ``sharded``, and
   counted in ``launches``; the decode kernel's launches on phase 15's
   eager D 4 stream under ``stream_mesh_launches`` and that phase's numbers
   under ``stream_mesh``, phase 16's under ``moe``'s
   ``expert_parallel``).

Times are medians of single calls between two CUDA events; below ~0.1 ms
that is mostly the wrapper's host time, so the decode kernel at the serving
shape and the flash kernel at the prefill shape, and their library calls,
are also timed per launch over 50 back-to-back launches between one pair
of events, over 50 launches captured in one CUDA graph and replayed (the
host's time per call left out), and by the device time per call that
``torch.profiler`` sees; the BSR kernels at each timed layer back to back
and from a CUDA graph, their library calls back to back.

The last line is ``{"ok": true, "device": {...}}``.  Any failed check
raises, and the script exits non-zero without printing it; it also exits
non-zero where no CUDA card is present.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

# cuBLAS reads its workspace configuration when its first handle is made;
# phase 14's restart check runs under deterministic algorithms, which want
# this one (the size PyTorch picks on Hopper by default)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

N, BATCH, P, LAYERS, SEED = 65536, 128, 64, 8, 0
# one layer of each block pattern: window offsets 0, 3 and 6, i.e. dense
# blocks (K 1), 4 nonzeros a block row (K 8) and 1 (K 32)
BSR_LAYERS = (0, 1, 2)
TOL = dict(rtol=1e-5, atol=1e-5)
E2E_TOL = dict(rtol=1e-4, atol=1e-4)
DECODE_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
              torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
# a bf16 output of a kernel that computes in fp32 and rounds once, against
# the plain version on fp32-widened inputs: one bf16 rounding (2^-8
# relative at most) and fp32 reassociation
ULP_TOL = dict(rtol=8e-3, atol=1e-4)
# and the share of its elements equal to that version rounded to bf16: an
# fp32 p·v misses it only by summation order (in 0.04-0.7% of the elements
# at the shapes here, most at S 8192), a p rounded to bf16 (as the plain
# version in bf16 rounds it) in about 42%
EXACT_SHARE = 0.98
# the bf16 SSD kernels, whose products are exact too (C·B of bf16, each
# fp32 operand split into three bf16 pieces), are held to EXACT_SHARE on y
# and to this on their fp32 state against the plain version, which widens
# the inputs to fp32: they read 1.4e-6-2.9e-6 and 99.98-99.995%, a build
# with the split cut to one piece 1.8e-2-3.0e-2 and 62-67%
SSD_STATE_TOL = dict(rtol=1e-4, atol=1e-4)
ARCH, SERVE_BATCH, PROMPT, NEW, NEW_FP32 = "internlm2-1.8b", 8, 512, 32, 8
DECODE_SHAPE = (SERVE_BATCH, 16, 8, 640, 128)   # B, H, KV, S, D of the path
# the paged form: (B, H, KV, S, D, block_k, dtypes) at the serving shape and
# at the benchmark cell's (128 slots of 1536, pages of 256), timed at the
# cell's mean length (prompts ~70 + outputs ~215)
PAGED_SHAPES = ((*DECODE_SHAPE, 128, (torch.bfloat16, torch.float32)),
                (128, 16, 8, 1536, 128, 256, (torch.bfloat16,)))
PAGED_LEN = 285
LONG_BATCH, LONG_S = 32, 32768                  # one long-cache layer
# bf16 logits, teacher-forced, kernel vs its plain version: the reference's
# model-level tolerance, which 24 bf16 layers break on a few entries (one
# rounding flip grows to ~0.06 in a logit), so at most 1% of a step's
# logits may fall outside it, and 90% of the greedy next tokens must agree
LOGITS_TOL = dict(rtol=3e-2, atol=3e-2)
LOGITS_OUTSIDE_MAX, AGREE_MIN = 0.01, 0.9
# flash attention: the reference's test shapes (B, H, KV, S, D), the
# serving model's prefill shape, one long shape
FLASH_TEST_SHAPES = ((2, 4, 4, 256, 64), (2, 8, 2, 256, 64), (1, 4, 4, 512, 128))
FLASH_SHAPE = (SERVE_BATCH, 16, 8, PROMPT, 128)
FLASH_LONG = (1, 16, 8, 8192, 128)
# SSD scan: the reference's test shapes (B, H, G, L, P, N, chunk) and one
# with G 3 of H 6 and 10 chunks of 96, mamba2's prefill shape and one long
# shape
SSM_ARCH = "mamba2-370m"
SSD_TEST_SHAPES = ((2, 4, 1, 256, 32, 16, 64), (1, 4, 2, 512, 64, 32, 128),
                   (2, 2, 2, 128, 32, 64, 128), (1, 6, 3, 960, 64, 128, 96))
SSD_LONG = (1, 32, 1, 16384, 64, 128, 256)
# fp32 mamba2-370m, the engine on the card against the same engine on the
# CPU: the reference's model-level tolerance (48 layers of fp32 sums in
# other orders, TF32 off, measured 5.031e-05 in two runs)
SSM_CPU_BATCH, SSM_CPU_PROMPT, SSM_CPU_NEW = 2, 256, 4
SSM_CPU_TOL = dict(rtol=1e-4, atol=1e-4)
# continuous batching at internlm2-1.8b's full width through torch-splitk:
# a ragged stream (prompts 64-512, budgets 8-64, arrivals over 24 steps)
# through 8 slots of capacity padded_len(512 + 64) = 640, the decode kernel
# first held to its plain version with one length per row (the rows'
# lengths below, at the serving shape); CB_SOLO of the requests in fp32
# against each one served alone (bit for bit) and against generate at B 1
# (tokens identical, logits within 1e-4); mamba2-370m's shorter stream:
# requests, slots, prompt lengths, budgets
CB_REQUESTS, CB_SLOTS, CB_MAX_LEN = 16, 8, PROMPT + 64
CB_PROMPTS, CB_BUDGETS, CB_ARRIVALS = (64, 512), (8, 64), 24
CB_SOLO = 4
TRACE_ATTEMPTS = 3     # traces of the graphed stream, until one is whole
CB_LENS = (0, 1, 63, 64, 65, 544, 640, 513)
CB_SSM = (8, 4, (64, 256), (4, 16))
# the padded prefill's graphs at the benchmark cell's slot capacity (512 +
# 1024: all eight buckets, 16 to 1536): a stream over the cell's prompt
# lengths (requests, prompts, budgets, arrivals) graphed against eager and
# teacher-forced against the unpadded prefill, then admissions of the
# cell's median prompt and of its longest timed both ways, each the median
# of CB_ADMIT_REPS
CB_CELL_CAP = 512 + 1024
CB_CELL_STREAM = (16, (8, 512), (4, 16), 8)
CB_ADMIT_LENS, CB_ADMIT_REPS = (43, 512), 10
# the sequence-sharded stream (phase 15): the shard counts over [cuda:0] * D,
# the capacity (phase 5b's requests fit; 1024 splits into 4 shards of two
# 128-key blocks), each row's position in the op-level check (either side
# of every shard edge), the fp32 depth cut's layers
MESH_DS, MESH_CAP = (1, 2, 4), 1024
MESH_POS = (0, 255, 256, 257, 511, 512, 767, 1023)
MESH_CUT = 4
# the LM pipeline at internlm2-1.8b's full width: stages, batch, prompt
# length and new tokens (phase 8)
PIPE_P, PIPE_BATCH, PIPE_PROMPT, PIPE_NEW = 4, 8, 128, 16
# deepseek-moe-16b at full width (phase 9): the decode kernel's cache
# lengths at its shape; the fp32 depth cut (layers; batch, prompt, new
# tokens) held to the CPU; the pipeline's batch, prompt and new tokens; the
# stream's requests, slots, prompt lengths and budgets
MOE_ARCH, MOE_LENS = "deepseek-moe-16b", (0, 1, 513, 544)
MOE_CUT, MOE_CPU = 4, (2, 64, 4)
MOE_PIPE = (4, 128, 8)
MOE_STREAM = (6, 4, (32, 128), (4, 16))
# expert parallelism (phase 16): the ("data", "model") mesh of the card; the
# layer's bf16 bound (the reference's, tests/test_moe_ep.py) and its fp32
# one relative to the largest |out|; the peak memory EP may add; the
# capacity of the D 2 sharded stream (256 splits into 2 x 2 blocks of 64)
EP_MESH = (1, 4)
EP_TOL = dict(rtol=2e-2, atol=2e-2)
EP_FP32_REL, EP_PEAK_GB = 1e-5, 2.0
MOE_MESH_CAP = 256
# zamba2-7b, seamless-m4t-medium and internvl2-2b at full width (phases
# 10-12): each one's prompt length for generate (batch SERVE_BATCH, NEW
# new tokens), the fp32 depth cut held to the CPU (config fields, run at
# FAMILY_CPU's batch, prompt and new tokens), which of the decode kernel's
# path shapes are timed in which dtypes (all are held to the plain
# version in bf16 and fp32), and internvl2-2b's pipeline (batch, prompt,
# new tokens); the stream of each: requests, slots, prompt lengths, budgets
# ``logit_gate``: whether the teacher-forced logits are held to the dense
# gate (``teacher_forced``); where not, they are reported and the next
# tokens gated.  zamba2's 81 layers and recurrent state carry one step's
# attention rounding past 3e-2 in 14% of the logits, internvl2's 256 image
# rows (normal, 50x the token embeddings' scale) in 1.1%, and in both two
# implementations without the kernel part further than the kernel and its
# plain version (PERF.md §6)
FAMILY_PHASES = {
    "zamba2-7b": dict(prompt=512, cut=dict(n_layers=7), logit_gate=False,
                      timed={"self": (torch.bfloat16, torch.float32)}),
    "seamless-m4t-medium": dict(prompt=128,
                                cut=dict(n_layers=2, n_encoder_layers=2),
                                logit_gate=True,
                                timed={"cross": (torch.bfloat16,)}),
    "internvl2-2b": dict(prompt=256, cut=dict(n_layers=2), logit_gate=False,
                         timed={}, pipeline=(4, 128, 8)),
}
FAMILY_CPU = (2, 64, 8)
# sparse_layer_apply on the card: N, batch, the weights' density, the bias
SPARSE_LAYER = (2048, 128, 0.05, -0.3)
# run_fsi over torch-bsr-sharded (phase 13): (channel, shards of the one
# card, dispatch); P 64 pads to 66 at 3 shards
SHARDED_RUNS = (("queue", 1, "fused"), ("queue", 1, "vmap"),
                ("object", 3, "fused"))
# training internlm2-1.8b (phase 14): batch, sequence; the steps at full
# depth (the first a warm-up, one profiled, the rest timed) and of the
# restart; the depth cut of the card-vs-CPU checks and of the restart; the
# CPU checks' batch and sequence; the fp32 check's loss (relative) and
# gradient (relative to each leaf's largest magnitude) tolerances and
# AdamW's update's; the bf16 check's, one bf16 rounding (2^-8) of the loss
# and 2e-2 of each leaf's largest magnitude; the first bf16 loss's
# distance from a random init's expected loss
TRAIN_BATCH, TRAIN_SEQ, TRAIN_CUT = 8, 512, 2
TRAIN_FULL_STEPS, TRAIN_PROFILE_STEP, TRAIN_STEPS = 8, 2, 4
TRAIN_CPU = (2, 128)
TRAIN_LOSS_TOL, TRAIN_GRAD_REL = 1e-5, 1e-4
TRAIN_UPDATE_TOL = dict(rtol=1e-6, atol=1e-6)
TRAIN_BF16_LOSS_REL, TRAIN_BF16_GRAD_REL = 2.0 ** -8, 2e-2
FIRST_LOSS_REL = 0.02
FAMILY_STREAM = (6, 4, (32, 128), (4, 16))
# the dry run (phase 17): the reference's gate cells on the production mesh,
# the example's archs for the route, the tolerance of the constants' memory
# against the card's, the phase's time limit (s)
DRYRUN_CELLS = (("llama3.2-1b", "train_4k"), ("internlm2-1.8b", "decode_32k"))
DRYRUN_ROUTE_ARCHS = ("internlm2-1.8b", "deepseek-moe-16b", "mamba2-370m")
DRYRUN_HBM_REL, DRYRUN_MAX_S = 0.01, 30.0
# real tensors on placements (phase 18): the reference's mesh, over
# [cuda:0] * 8 and ["cpu"] * 8; the batch's step; the data-parallel shards
# of compressed_psum (four batches' gradients); the phase's time limit (s)
PLACE_MESH = ((2, 4), ("data", "model"))
PLACE_BATCH_STEP, PSUM_SHARDS, PLACE_MAX_S = 7, 4, 60.0
# builds of a kernel source with one piece of text replaced, each built
# beside the others at the start: name -> (source, old, new).  The BSR
# sweeps time a one-stage ring and a walk without the non-finite test; the
# SSD control cuts split3 to one piece (its fp32 operand rounded to bf16
# once), which the bf16 SSD checks must tell from the kernels.
VARIANTS = {
    "one_stage": ("bsr_spmm.cu", "constexpr int kStages = 2;",
                  "constexpr int kStages = 1;"),
    "unchecked": ("bsr_spmm.cu", "__syncthreads_or(copied_x_nonfinite<Vec>"
                  "(ws + kBlk * kBlk)) != 0;", "(__syncthreads(), false);"),
    "one_piece": ("ssd_scan.cu", "  w[1] = __float2bfloat16_rn(r);\n"
                  "  w[2] = __float2bfloat16_rn(r - __bfloat162float(w[1]));",
                  "  w[1] = w[2] = __float2bfloat16_rn(0.f);\n  (void)r;"),
}
SOURCES = {"bsr_spmm_fused": "src/repro_torch/kernels/bsr_spmm/csrc/bsr_spmm.cu",
           "bsr_spmm_fleet": "src/repro_torch/kernels/bsr_spmm/csrc/bsr_spmm.cu",
           "decode_attention": ("src/repro_torch/kernels/decode_attention/csrc/"
                                "decode_attention.cu"),
           "flash_attention": ("src/repro_torch/kernels/flash_attention/csrc/"
                               "flash_attention.cu"),
           "ssd_scan": "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu"}
REPLACES = {"bsr_spmm_fused": "src/repro/kernels/bsr_spmm/bsr_spmm.py:180",
            "bsr_spmm_fleet": "src/repro/kernels/bsr_spmm/bsr_spmm.py:125",
            "decode_attention":
                "src/repro/kernels/decode_attention/decode_attention.py:59",
            "flash_attention":
                "src/repro/kernels/flash_attention/flash_attention.py:62",
            "ssd_scan": "src/repro/kernels/ssd_scan/ssd_scan.py:68"}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def peaks_for(name: str):
    """``(kind, (HBM bytes/s, fp32 FLOP/s outside the tensor cores, dense
    bf16 tensor-core FLOP/s))`` of the card, from the package's data-sheet
    table (``core/cost_model.py::ACCELERATORS``)."""
    from repro_torch.core.cost_model import accelerator_for

    kind, c = accelerator_for(name)
    return kind, (c.hbm_bandwidth, c.peak_fp32_flops, c.peak_bf16_flops)


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median of ``reps`` runs, each between two CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def graph_ms(fn, n: int = 50, reps: int = 5) -> float:
    """Per-call time of ``n`` calls captured in one CUDA graph, replayed
    between two CUDA events (median of ``reps`` replays): back to back with
    none of the host's time per call.  The calls are warmed up on the
    capture stream first, so scratch that a wrapper keeps per stream is
    made there and not inside the capture."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        graph.replay()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / n)
    del graph
    return statistics.median(times)


def back_to_back_ms(fn, n: int = 50, reps: int = 5) -> float:
    """Per-launch time of ``n`` back-to-back calls between one pair of CUDA
    events (median of ``reps`` bursts)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(n):
            fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / n)
    return statistics.median(times)


def burst_ms(fn, n: int = 50, reps: int = 5):
    """``back_to_back_ms`` of ``n`` calls, ``graph_ms`` of ``n`` calls, and
    the device time per call that ``torch.profiler`` sees over ``n`` more
    (None where it sees none)."""
    from torch.profiler import ProfilerActivity, profile

    burst = back_to_back_ms(fn, n, reps)
    graph = graph_ms(fn, n, reps)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    dev_us = sum(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
                 for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    return burst, graph, dev_us / 1e3 / n if dev_us > 0 else None


def fmt_ms(x) -> str:
    return "not measured" if x is None else f"{x:.4f}"


def compare(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    torch.cuda.synchronize()
    err = (got - want).abs()
    rel = (err / want.abs().clamp_min(1e-30)).max().item()
    log(f"  {name}: shape {tuple(got.shape)} max_abs_err {err.max().item():.3e} "
        f"max_rel_err {rel:.3e} (tolerance rtol=atol=1e-5)")
    torch.testing.assert_close(got, want, **TOL)
    return err.max().item()


def exact_share(got: torch.Tensor, want: torch.Tensor) -> float:
    """The share of the bf16 ``got``'s elements equal to ``want`` rounded
    to bf16."""
    return (got == want.to(torch.bfloat16)).float().mean().item()


def bsr_library_call(blocks, cols, counts, x, n_cols_blocks, bias, clip):
    """One PyTorch call computing the fleet's layer op: a block-diagonal
    ``torch.sparse_bsr_tensor`` of every worker's real blocks times the
    stacked x, then the clamp.  A yardstick only; the port never calls it.
    Returns the call and its first result."""
    p, nbr, k, bm, bn = blocks.shape
    b = x.shape[-1]
    real = torch.arange(k, device=blocks.device) < counts[..., None].long()
    offs = (torch.arange(p, device=blocks.device) * n_cols_blocks)[:, None, None]
    values = blocks[real].contiguous()
    col = (cols.long() + offs)[real].to(torch.int32).contiguous()
    crow = torch.zeros(p * nbr + 1, dtype=torch.int32, device=blocks.device)
    crow[1:] = counts.reshape(-1).cumsum(0)
    a = torch.sparse_bsr_tensor(crow, col, values,
                                size=(p * nbr * bm, p * n_cols_blocks * bn),
                                check_invariants=False)
    xf = x.reshape(p * n_cols_blocks * bn, b)

    def call():
        return torch.clamp(a @ xf + bias, 0.0, clip)

    y = call().reshape(p, nbr * bm, b)
    return call, y


def bound(blocks, cols, counts, b: int, peaks):
    """Least time for the layer op on this data: the larger of every byte
    it needs once over HBM and every FMA it needs (one a nonzero weight and
    batch column) over the fp32 peak, as ``ops.layer_work`` counts them."""
    from repro_torch.kernels.bsr_spmm.ops import layer_work

    bytes_, flops = layer_work(blocks, cols, counts, b)
    t_bytes, t_ops = bytes_ / peaks[0] * 1e3, flops / peaks[1] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            bytes_, flops)


def variant(name: str):
    """The library of ``VARIANTS[name]``: its kernel source with one piece
    of text replaced, built into the module's ``build/<name>/``."""
    from repro_torch.kernels import _build

    source, old, new = VARIANTS[name]
    mod = kernel_modules()[source]
    text = mod._SOURCE.read_text()
    check(text.count(old) == 1, f"{source} no longer holds {old!r}")
    src = mod._HERE / "build" / name / source
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(text.replace(old, new))
    return _build.load(src, _build.library_path(src, src.parent, "lib.so"),
                       mod._configure)


def variant_fused(lib, blocks, cols, x, bias):
    """A call that launches ``lib``'s fused kernel as the wrapper launches
    it, writing into the tensor returned beside it."""
    nbr, k, bm, bn = blocks.shape
    n, b = x.shape
    y = torch.empty((nbr * bm, b), dtype=torch.float32, device=x.device)

    def call():
        err = lib.bsr_spmm_fused_launch(
            blocks.data_ptr(), cols.data_ptr(), x.data_ptr(), y.data_ptr(),
            nbr, k, bm, bn, n, b, float(bias), 32.0,
            torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"bsr_spmm_fused variant: CUDA error {err}")

    return call, y


def variant_fleet(lib, blocks, cols, counts, x, bias):
    """As ``variant_fused``, for ``lib``'s fleet kernel."""
    p, nbr, k, bm, bn = blocks.shape
    n, b = x.shape[1:]
    y = torch.empty((p, nbr * bm, b), dtype=torch.float32, device=x.device)

    def call():
        err = lib.bsr_spmm_fleet_launch(
            blocks.data_ptr(), cols.data_ptr(), counts.data_ptr(),
            x.data_ptr(), y.data_ptr(), p, nbr, k, bm, bn, n, b, float(bias),
            32.0, torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"bsr_spmm_fleet variant: CUDA error {err}")

    return call, y


def nonfinite_row(cols, counts, g) -> int:
    """A random row of x in a column block >= 1 that one of the real blocks
    (``cols [NBR, K]`` below ``counts [NBR]``) references."""
    real = torch.arange(cols.shape[1], device=cols.device) < counts[:, None]
    col_blocks = torch.unique(cols[real])
    col_blocks = col_blocks[col_blocks > 0].cpu().numpy()
    return int(g.choice(col_blocks)) * 32 + int(g.integers(0, 32))


def interleaved_graph_ms(calls: dict, order) -> dict:
    """``graph_ms`` of each named call, taken in ``order`` (names may
    repeat), as lists by name."""
    out = {name: [] for name in calls}
    for name in order:
        out[name].append(graph_ms(calls[name]))
    return out


def kernel_modules() -> dict:
    """Each kernel source's wrapper module."""
    from repro_torch.kernels.bsr_spmm import ops as bsr_ops
    from repro_torch.kernels.decode_attention import ops as decode_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops

    return {"bsr_spmm.cu": bsr_ops, "decode_attention.cu": decode_ops,
            "flash_attention.cu": flash_ops, "ssd_scan.cu": ssd_ops}


def reset_counts() -> None:
    for mod in kernel_modules().values():
        for key in mod.LAUNCHES:
            mod.LAUNCHES[key] = 0


def read_counts() -> dict:
    counts = {}
    for mod in kernel_modules().values():
        counts.update(mod.LAUNCHES)
    return counts


def only(counts: dict, **want) -> dict:
    """``want`` with every other kernel at 0, to hold a path's counts to."""
    return {key: want.get(key, 0) for key in counts}


def fsi_phases(dev, peaks, card):
    """Phases 2 and 3: the BSR kernels against their plain versions at one
    layer of each block pattern, then ``run_fsi`` through them.  Returns
    (timing, launches, max errors, the FSI runs for phase 13: the net, x0,
    ``dense_inference``'s output, the partition and, by channel, the
    ``torch-bsr`` output, the ``numpy-fast`` run and the host wall)."""
    from repro_torch.core.backends import TorchBsrBackend
    from repro_torch.core.fsi import prepare_worker_artifacts
    from repro_torch.core.partitioner import partition_network
    from repro_torch.core.send_recv import build_comm_plans
    from repro_torch.core.sparse import bsr_from_csr
    from repro_torch.data.graphchallenge import (
        GraphChallengeNet, dense_inference, make_inputs, make_sparse_dnn)
    from repro_torch.faas.simulator import run_fsi
    from repro_torch.kernels.bsr_spmm import ops, ref

    log(f"[config] GraphChallenge N={N}, batch {BATCH}, blocks 32x32, P={P}, "
        f"{LAYERS} layers of 120 (depth cut for the time limit; width, block "
        f"shape and batch panel are the real ones; 8 layers cover every "
        f"window offset 0/3/6/9 twice), weights from seed {SEED}")
    t = time.time()
    net = make_sparse_dnn(N, n_layers=LAYERS, seed=SEED)
    x0 = make_inputs(N, BATCH, seed=1)
    acts = [x0]  # each timed layer's input
    for j in range(max(BSR_LAYERS)):
        acts.append(dense_inference(
            GraphChallengeNet(N, [net.layers[j]], net.bias), acts[-1]))
    log(f"[data] net + inputs + activations of layers {BSR_LAYERS}: "
        f"{time.time() - t:.1f} s")

    be = TorchBsrBackend(device="cuda")
    t = time.time()
    partition = partition_network(net.layers, P, method="hgp", seed=SEED)
    plans = build_comm_plans(net.layers, partition)
    arts = prepare_worker_artifacts(net.layers, partition, plans, backend=be)
    fleets = be.fleet_prepare_all(
        [[arts[m].layers[j].state_for(be) for m in range(P)]
         for j in range(LAYERS)])
    # a layer's block pattern: the most nonzeros in one row of one block
    pattern = [int((f.blocks != 0).sum(-1).max()) for f in fleets]
    log(f"[kernels] partition + artifacts + fleets: {time.time() - t:.1f} s; "
        f"nonzeros a block row by layer {pattern}")

    libs = {name: variant(name) for name in ("one_stage", "unchecked")}
    err_fused, err_fleet, by_layer = [], [], []
    for layer in BSR_LAYERS:
        x_in = acts[layer]
        bsr = bsr_from_csr(net.layers[layer], (32, 32), pad=True)
        blocks_np, cols_np, counts_np = bsr.padded()
        blocks = torch.from_numpy(blocks_np).to(dev)
        cols = torch.from_numpy(cols_np).to(dev)
        counts = torch.from_numpy(counts_np.astype(np.int32)).to(dev)
        x = torch.from_numpy(np.ascontiguousarray(x_in, np.float32)).to(dev)
        nbr, k = blocks_np.shape[:2]
        log(f"[kernels] layer {layer}, serial: blocks [{nbr},{k},32,32] "
            f"({blocks_np.nbytes / 1e6:.0f} MB), x [{N},{BATCH}], "
            f"{int(counts_np.sum())} real blocks of {nbr * k}, "
            f"{net.layers[layer].nnz} nonzeros, {pattern[layer]} a block row")
        y_k = ops.bsr_spmm(blocks, cols, x, bias=net.bias)
        y_p = ref.bsr_spmm_fused_ref(blocks, cols, x, net.bias)
        err_fused.append(compare(f"layer {layer} fused vs plain", y_k, y_p))

        fleet = fleets[layer]
        X = np.zeros((P, fleet.n_pad, BATCH), np.float32)
        for m in range(P):
            rows = arts[m].layers[layer].needed_rows
            X[m, : len(rows)] = x_in[rows]
        fx = torch.from_numpy(X).to(dev)
        log(f"[kernels] layer {layer}, fleet: blocks "
            f"{list(fleet.blocks.shape)} "
            f"({fleet.blocks.numel() * 4 / 1e6:.0f} MB), x {list(fx.shape)}, "
            f"{int(fleet.counts.sum())} real blocks of "
            f"{fleet.counts.numel() * fleet.blocks.shape[2]}")
        fy_k = ops.bsr_spmm_fleet(fleet.blocks, fleet.cols, fleet.counts, fx,
                                  bias=net.bias)
        fy_p = ref.bsr_spmm_fleet_ref(fleet.blocks, fleet.cols, fleet.counts,
                                      fx, net.bias)
        err_fleet.append(compare(f"layer {layer} fleet vs plain", fy_k, fy_p))
        for m in range(P):
            per = ops.bsr_spmm(fleet.blocks[m], fleet.cols[m], fx[m],
                               bias=net.bias)
            check(torch.equal(per, fy_k[m]),
                  f"layer {layer}: fleet != per-worker for worker {m}")
        log(f"  layer {layer}: fleet == per-worker kernel, bitwise, for all "
            f"{P} workers")
        del y_p, fy_p

        if layer == BSR_LAYERS[-1]:
            # ragged: batch not a multiple of the 128-column tile, a
            # zero-count worker
            g = np.random.default_rng(SEED)
            rb = 200
            rblocks = torch.cat([fleet.blocks[:3],
                                 torch.zeros_like(fleet.blocks[:1])])
            rcols = torch.cat([fleet.cols[:3], torch.zeros_like(fleet.cols[:1])])
            rcounts = torch.cat([fleet.counts[:3],
                                 torch.zeros_like(fleet.counts[:1])])
            rx = torch.from_numpy(g.uniform(0, 2, (4, fleet.n_pad, rb))
                                  .astype(np.float32)).to(dev)
            ry_k = ops.bsr_spmm_fleet(rblocks, rcols, rcounts, rx,
                                      bias=net.bias)
            err_fleet.append(compare(
                "ragged fleet (batch 200, zero-count worker) vs plain", ry_k,
                ref.bsr_spmm_fleet_ref(rblocks, rcols, rcounts, rx, net.bias)))
            check(torch.equal(ry_k[3], torch.zeros_like(ry_k[3])),
                  "zero-count worker produced nonzero output")
            for m in range(4):
                per = ops.bsr_spmm(rblocks[m], rcols[m], rx[m], bias=net.bias)
                check(torch.equal(per, ry_k[m]),
                      f"ragged fleet != per-worker for worker {m}")
                err_fused.append(compare(
                    f"ragged fused worker {m} vs plain", per,
                    ref.bsr_spmm_fused_ref(rblocks[m], rcols[m], rx[m],
                                           net.bias)))
            log("  ragged fleet == per-worker kernel, bitwise")
            del rblocks, rcols, rcounts, rx, ry_k

        # timings at this layer's shapes
        path_layers = pattern.count(pattern[layer])
        for kname, kern, plain, operands, y_ref in (
            ("bsr_spmm_fused",
             lambda: ops.bsr_spmm(blocks, cols, x, bias=net.bias),
             lambda: ref.bsr_spmm_fused_ref(blocks, cols, x, net.bias),
             (blocks[None], cols[None], counts[None], x[None], N // 32), y_k),
            ("bsr_spmm_fleet",
             lambda: ops.bsr_spmm_fleet(fleet.blocks, fleet.cols,
                                        fleet.counts, fx, bias=net.bias),
             lambda: ref.bsr_spmm_fleet_ref(fleet.blocks, fleet.cols,
                                            fleet.counts, fx, net.bias),
             (fleet.blocks, fleet.cols, fleet.counts, fx, fleet.n_pad // 32),
             fy_k),
        ):
            ms, plain_ms = time_ms(kern), time_ms(plain)
            k_burst, k_graph = back_to_back_ms(kern), graph_ms(kern)
            lib_ms = lib_burst = lib_err = None
            try:
                call, y_lib = bsr_library_call(*operands, net.bias, be.clip)
                lib_ms, lib_burst = time_ms(call), back_to_back_ms(call)
                lib_err = (y_lib.reshape(y_ref.shape) - y_ref).abs().max().item()
                del call, y_lib
            except (RuntimeError, NotImplementedError, ValueError,
                    TypeError) as e:
                log(f"  {kname}: library call refused: {type(e).__name__}: {e}")
            b_ms, b_by, nbytes, flops = bound(*operands[:3], BATCH, peaks)
            by_layer.append(dict(
                name=kname, layer=layer, k=int(operands[0].shape[2]),
                nonzeros_a_block_row=pattern[layer], path_layers=path_layers,
                ms=ms, burst_ms=k_burst, graph_ms=k_graph, plain_ms=plain_ms,
                library_ms=lib_ms, library_burst_ms=lib_burst, bound_ms=b_ms,
                bound_by=b_by))
            log(f"[time] {kname} layer {layer} (K {operands[0].shape[2]}, "
                f"{pattern[layer]} nonzeros a block row, {path_layers} of the "
                f"{LAYERS} path layers): kernel {ms:.4f} ms a single call, "
                f"{k_burst:.4f} back to back, {k_graph:.4f} from a CUDA graph; "
                f"plain {plain_ms:.4f} ms; library {fmt_ms(lib_ms)} ms, "
                f"{fmt_ms(lib_burst)} back to back (max |library - kernel| "
                f"{lib_err}); bound "
                f"{b_ms:.4f} ms by {b_by} ({nbytes / 1e6:.1f} MB, "
                f"{flops / 1e9:.3f} GFLOP; from the graph {nbytes / k_graph / 1e9:.3f}"
                f" TB/s, {flops / k_graph / 1e9:.2f} TFLOP/s, "
                f"{k_graph / b_ms:.2f}x the bound) on {card}")
        # the ring's depth: the kernel against a one-stage build of its
        # source, from CUDA graphs in the order ring, one, one, ring
        one_stage, y_one = variant_fused(libs["one_stage"], blocks, cols, x,
                                         net.bias)
        one_stage()
        torch.cuda.synchronize()
        check(torch.equal(y_one, y_k), f"layer {layer}: one-stage != ring")
        depth = interleaved_graph_ms(
            {"ring": lambda: ops.bsr_spmm(blocks, cols, x, bias=net.bias),
             "one_stage": one_stage}, ("ring", "one_stage", "one_stage", "ring"))
        rows = {r["name"]: r for r in by_layer if r["layer"] == layer}
        rows["bsr_spmm_fused"].update(ring_graph_ms=depth["ring"],
                                      one_stage_graph_ms=depth["one_stage"])
        log(f"[sweep] bsr_spmm_fused layer {layer} ring depth, ms a launch "
            f"from a CUDA graph: 2 stages {depth['ring']}, 1 stage "
            f"{depth['one_stage']} (bitwise equal) on {card}")

        # the non-finite test's cost: each kernel against a build of its
        # source without the test (the skipping walk alone), bitwise equal
        # on this finite x, from CUDA graphs in the order with, without,
        # without, with
        for kname, call, y_with, unchecked in (
            ("bsr_spmm_fused",
             lambda: ops.bsr_spmm(blocks, cols, x, bias=net.bias), y_k,
             variant_fused(libs["unchecked"], blocks, cols, x, net.bias)),
            ("bsr_spmm_fleet",
             lambda: ops.bsr_spmm_fleet(fleet.blocks, fleet.cols,
                                        fleet.counts, fx, bias=net.bias),
             fy_k,
             variant_fleet(libs["unchecked"], fleet.blocks, fleet.cols,
                           fleet.counts, fx, net.bias)),
        ):
            unchecked[0]()
            torch.cuda.synchronize()
            check(torch.equal(unchecked[1], y_with),
                  f"layer {layer}: {kname} without the non-finite test differs")
            cost = interleaved_graph_ms(
                {"with": call, "without": unchecked[0]},
                ("with", "without", "without", "with"))
            rows[kname].update(nonfinite_test_graph_ms=cost["with"],
                               without_test_graph_ms=cost["without"])
            log(f"[sweep] {kname} layer {layer} non-finite test, ms a launch "
                f"from a CUDA graph: with {cost['with']}, without "
                f"{cost['without']} (bitwise equal; "
                f"{min(cost['with']) / min(cost['without']) - 1:+.2%}) on "
                f"{card}")
            del unchecked

        # non-finite x: Inf, -Inf and NaN in rows of column blocks 1 and up
        # that real blocks reference (the fleet's padding slots reference
        # column block 0)
        g = np.random.default_rng(SEED + layer)
        xn, fxn = x.clone(), fx.clone()
        for val in (float("inf"), float("-inf"), float("nan")):
            for _ in range(8):
                xn[nonfinite_row(cols, counts, g), g.integers(0, BATCH)] = val
                m = g.integers(0, P)
                fxn[m, nonfinite_row(fleet.cols[m], fleet.counts[m], g),
                    g.integers(0, BATCH)] = val
        outs = []
        for kname, got, want in (
            ("fused", ops.bsr_spmm(blocks, cols, xn, bias=net.bias),
             ref.bsr_spmm_fused_ref(blocks, cols, xn, net.bias)),
            ("fleet", ops.bsr_spmm_fleet(fleet.blocks, fleet.cols,
                                         fleet.counts, fxn, bias=net.bias),
             ref.bsr_spmm_fleet_ref(fleet.blocks, fleet.cols, fleet.counts,
                                    fxn, net.bias)),
        ):
            torch.cuda.synchronize()
            nan_k, nan_p = got.isnan(), want.isnan()
            check(bool(nan_p.any()), f"layer {layer} {kname}: no NaN to hold")
            check(torch.equal(nan_k, nan_p),
                  f"layer {layer} {kname}: NaN at {int((nan_k != nan_p).sum())} "
                  f"places where the plain version has none or the reverse")
            torch.testing.assert_close(got, want, equal_nan=True, **TOL)
            err = (got - want)[~nan_p].abs().max().item()
            outs.append(f"{kname} {int(nan_k.sum())} NaN of {got.numel()}, "
                        f"the rest max_abs_err {err:.3e}")
            del got, want, nan_k, nan_p
        log(f"[check] bsr non-finite x, layer {layer} (8 each of Inf, -Inf "
            f"and NaN in column blocks >= 1): NaN exactly where the plain "
            f"versions have it: {'; '.join(outs)} (tolerance 1e-5)")
        del blocks, cols, counts, x, fx, xn, fxn, y_k, fy_k, one_stage, y_one
        torch.cuda.empty_cache()

    # the JSON line's numbers: the last timed layer (K 32, the most blocks)
    # and every timed layer under by_layer
    timing = {}
    for kname in ("bsr_spmm_fused", "bsr_spmm_fleet"):
        rows = [r for r in by_layer if r["name"] == kname]
        timing[kname] = {key: rows[-1][key] for key in
                         ("ms", "burst_ms", "graph_ms", "plain_ms",
                          "library_ms", "library_burst_ms", "bound_ms",
                          "bound_by")}
        timing[kname]["by_layer"] = [
            {key: v for key, v in r.items() if key != "name"} for r in rows]
    del fleets
    torch.cuda.empty_cache()

    # ---- 3. the FSI path -------------------------------------------------
    dense = dense_inference(net, x0)
    launches = {key: 0 for key in ops.LAUNCHES}
    fsi_runs = {}
    runs = [("queue", dict(P=P, channel="queue", partition=partition)),
            ("object", dict(P=P, channel="object", partition=partition)),
            ("serial", dict(channel="serial"))]
    for ch, kw in runs:
        t = time.time()
        want = run_fsi(net, x0, compute_backend="numpy-fast", **kw)
        t_np = time.time() - t
        reset_counts()
        t = time.time()
        got = run_fsi(net, x0, compute_backend=TorchBsrBackend(device="cuda"),
                      **kw)
        t_gpu = time.time() - t
        counts_run = read_counts()
        out = got.output
        check(out.shape == (N, BATCH) and bool(np.isfinite(out).all()),
              f"{ch}: output shape {out.shape} or non-finite values")
        err = float(np.abs(out - dense).max())
        np.testing.assert_allclose(out, dense, **E2E_TOL)
        if ch == "serial":
            check(got.metrics["flops"] == want.metrics["flops"], f"{ch}: flops")
            want_counts = {"bsr_spmm_fused": LAYERS, "bsr_spmm_fleet": 0}
        else:
            for key in ("flops_total", "messages"):
                check(got.metrics.get(key) == want.metrics.get(key), f"{ch}: {key}")
            check(got.raw_exchange_bytes == want.raw_exchange_bytes,
                  f"{ch}: raw exchange bytes")
            want_counts = {"bsr_spmm_fused": 0, "bsr_spmm_fleet": LAYERS}
        check(counts_run == only(counts_run, **want_counts),
              f"{ch}: launches {counts_run}")
        rel_cost = abs(got.cost.total - want.cost.total) / want.cost.total
        check(rel_cost <= 0.05, f"{ch}: cost differs by {rel_cost:.3%}")
        for key in launches:
            launches[key] += counts_run[key]
        fsi_runs[ch] = (out, want, t_gpu)
        log(f"[run_fsi] {ch}: torch-bsr {t_gpu:.2f} s host wall, numpy-fast "
            f"{t_np:.2f} s; max |out - dense_inference| {err:.3e}; "
            f"flops {got.metrics.get('flops_total', got.metrics.get('flops'))}, "
            f"messages {got.metrics.get('messages')}, raw bytes "
            f"{got.raw_exchange_bytes} (equal to numpy-fast); cost "
            f"{got.cost.total:.6e} vs {want.cost.total:.6e}; launches {counts_run}")
    for key, v in launches.items():
        check(v > 0, f"{key} was not launched on the FSI path")
    log(f"[memory] FSI phases: peak device allocation "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    errs = {"bsr_spmm_fused": max(err_fused), "bsr_spmm_fleet": max(err_fleet)}
    fsi = dict(net=net, x0=x0, dense=dense, partition=partition, runs=fsi_runs)
    return timing, launches, errs, fsi


# ---------------------------------------------------------------------------
# 4. the decode kernel against its plain version
# ---------------------------------------------------------------------------


def back_to_back(name: str, tag: str, kernel, library) -> dict:
    """``burst_ms`` of the kernel and of the library call (where there is
    one), logged; returns them as extra keys of the kernel's timing."""
    k_ms, k_graph, k_dev = burst_ms(kernel)
    l_ms, l_graph, l_dev = (burst_ms(library) if library is not None
                            else (None, None, None))
    def dev(x):
        return ("device time not measured" if x is None
                else f"{x:.4f} ms of device time a call")

    log(f"[time] {name} {tag}, 50 back-to-back launches: kernel "
        f"{k_ms:.4f} ms a launch, {k_graph:.4f} from a CUDA graph "
        f"({dev(k_dev)}), library {fmt_ms(l_ms)} ms a launch, "
        f"{fmt_ms(l_graph)} from a CUDA graph ({dev(l_dev)})")
    return dict(burst_ms=k_ms, graph_ms=k_graph, device_ms=k_dev,
                library_burst_ms=l_ms, library_graph_ms=l_graph,
                library_device_ms=l_dev)


def decode_bound(B, H, KV, L, D, dtype, peaks):
    """Least time for one decode call: q, the first ``L`` rows of K and V,
    out and lse each moved once over HBM, against 4·B·H·L·D FLOPs over the
    peak for the inputs' type (bf16 tensor cores, or fp32)."""
    e = torch.tensor([], dtype=dtype).element_size()
    bytes_ = 2 * B * H * D * e + 2 * B * KV * L * D * e + B * H * 4
    flops = 4.0 * B * H * L * D
    peak = peaks[2] if dtype == torch.bfloat16 else peaks[1]
    t_bytes, t_ops = bytes_ / peaks[0] * 1e3, flops / peak * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            bytes_, flops)


def sdpa_call(q, k, v, L=None, causal=False):
    """One ``scaled_dot_product_attention`` call, the KV heads shared by their
    G query heads: for a decode query ``q [B, H, D]`` over the first ``L``
    cache rows, or (``L`` None) for prefill ``q [B, H, Sq, D]`` over all of
    k and v.  A yardstick only; the port never calls it."""
    F = torch.nn.functional
    if L is None:
        return lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True)
    qs, ks, vs = q[:, :, None], k[:, :, :L], v[:, :, :L]
    return lambda: F.scaled_dot_product_attention(qs, ks, vs,
                                                  enable_gqa=True)[:, :, 0]


def paged_check(dev, peaks, card):
    """The kernel's paged form at ``PAGED_SHAPES``: K and V in shuffled
    pages of layer 1 of a two-layer buffer (the pool's page stride), each
    length at 0, 1, every page's edges +-1 and the capacity, and one length
    a row, against the plain version (``DECODE_TOL``) and bit for bit the
    contiguous kernel over the gathered copy; then both forms from a CUDA
    graph at ``PAGED_LEN`` beside the bytes bound.  Returns (timing by
    shape, max error)."""
    from repro_torch.kernels.decode_attention import ops, ref

    gen = torch.Generator().manual_seed(SEED + 7)
    dgen = torch.Generator(device=dev).manual_seed(SEED + 7)
    timing, worst = {}, 0.0
    for B, H, KV, S, D, bk, dtypes in PAGED_SHAPES:
        W = S // bk
        nb = B * W + 3
        table = torch.randperm(nb, generator=gen)[:B * W].view(B, W).to(
            dev, torch.int32)
        edges = {0, 1, S}
        for e in range(bk, S, bk):
            edges.update((e - 1, e, e + 1))
        rows = torch.randint(1, S + 1, (B,), generator=gen, dtype=torch.int32)
        lens = [torch.tensor([L], dtype=torch.int32, device=dev)
                for L in sorted(edges)] + [rows.to(dev)]
        for dtype in dtypes:
            tag = f"B{B} H{H} KV{KV} S{S} D{D} pages of {bk} {dtype}"
            q, k, v = (torch.randn(shape, generator=dgen, device=dev,
                                   dtype=dtype)
                       for shape in ((B, H, D), (nb, 2, KV, bk, D),
                                     (nb, 2, KV, bk, D)))
            k, v = k[:, 1], v[:, 1]
            kc, vc = ref.gather_pages(k, table), ref.gather_pages(v, table)
            err = 0.0
            for lt in lens:
                out, lse = ops.decode_mha_paged(q, k, v, table, lt)
                want, want_lse = ops.decode_mha(q, kc, vc, lt)
                plain, plain_lse = ref.decode_attention_paged_ref(q, k, v,
                                                                  table, lt)
                torch.cuda.synchronize()
                check(torch.equal(out, want) and torch.equal(lse, want_lse),
                      f"paged {tag} at lengths {lt.tolist()[:4]}: not bit "
                      f"for bit the contiguous kernel over the gathered copy")
                torch.testing.assert_close(out.float(), plain.float(),
                                           **DECODE_TOL[dtype])
                torch.testing.assert_close(lse, plain_lse, **DECODE_TOL[dtype])
                err = max(err, (out.float() - plain.float()).abs().max().item())
            worst = max(worst, err)
            lt = torch.tensor([PAGED_LEN], dtype=torch.int32, device=dev)
            paged_ms = graph_ms(lambda: ops.decode_mha_paged(q, k, v, table, lt))
            flat_ms = graph_ms(lambda: ops.decode_mha(q, kc, vc, lt))
            b_ms, b_by, nbytes, _ = decode_bound(B, H, KV, PAGED_LEN, D, dtype,
                                                 peaks)
            log(f"[time] decode_attention_paged {tag}: {len(lens)} lengths "
                f"bit for bit the contiguous kernel over the gathered copy, "
                f"max |paged - plain| {err:.3e} (tolerance "
                f"{DECODE_TOL[dtype]['atol']}); at cache_len {PAGED_LEN} from "
                f"a CUDA graph paged {paged_ms:.4f} ms, contiguous "
                f"{flat_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by} "
                f"({nbytes / 1e6:.1f} MB; paged {nbytes / paged_ms / 1e6:.1f} "
                f"GB/s) on {card}")
            timing[tag] = dict(graph_ms=paged_ms, contiguous_graph_ms=flat_ms,
                               bound_ms=b_ms, max_abs_err=err)
            del q, k, v, kc, vc
        torch.cuda.empty_cache()
    return timing, worst


def decode_phase(dev, peaks, card):
    """The kernel against its plain version, its paged form
    (:func:`paged_check`), then its times.  Returns (timing, max error)."""
    from repro_torch.kernels.decode_attention import ops, ref

    gen = torch.Generator(device=dev).manual_seed(SEED)

    def operands(B, H, KV, S, D, dtype):
        return [torch.randn(shape, generator=gen, device=dev, dtype=dtype)
                for shape in ((B, H, D), (B, KV, S, D), (B, KV, S, D))]

    def held(name, q, k, v, lens):
        worst = 0.0
        tol = DECODE_TOL[q.dtype]
        for L in lens:
            lt = torch.tensor([L], dtype=torch.int32, device=dev)
            out, lse = ops.decode_mha(q, k, v, lt)
            want, want_lse = ref.decode_attention_ref(q, k, v, lt)
            torch.cuda.synchronize()
            err = (out.float() - want.float()).abs().max().item()
            lse_err = (lse - want_lse).abs().max().item()
            torch.testing.assert_close(out.float(), want.float(), **tol,
                                       msg=lambda m: f"{name} L={L}: {m}")
            torch.testing.assert_close(lse, want_lse, **tol,
                                       msg=lambda m: f"{name} L={L} lse: {m}")
            worst = max(worst, err)
            log(f"  {name} cache_len {L}: max_abs_err out {err:.3e}, "
                f"lse {lse_err:.3e} (tolerance rtol=atol={tol['atol']})")
        return worst

    B, H, KV, S, D = DECODE_SHAPE
    tile = ops.SPLIT_TILE
    main = {dt: operands(B, H, KV, S, D, dt)
            for dt in (torch.bfloat16, torch.float32)}
    edges = set()
    for dtype, (q, k, v) in main.items():
        n_split, split_keys = ops.plan_for(q, k)
        log(f"  decode split plan at the serving shape, {dtype}: {n_split} "
            f"splits of {split_keys} keys")
        for j in range(n_split):  # each split's first and last key, +-1
            for e in (j * split_keys, min((j + 1) * split_keys, S) - 1):
                edges.update((e - 1, e, e + 1))
    lens = sorted({0, 1, tile - 1, tile, tile + 1, PROMPT + NEW, S}
                  | {e for e in edges if 0 <= e <= S})
    log(f"  decode cache lengths {lens}")
    errs = [held(f"main B{B} H{H} KV{KV} S{S} D{D} {dtype}", *main[dtype], lens)
            for dtype in (torch.bfloat16, torch.float32)]
    # the launch plan is keyed by capacity, not length: a decode loop over a
    # growing cache adds no plan after its first step
    q, k, v = main[torch.bfloat16]
    ops.decode_mha(q, k, v, torch.tensor([1], dtype=torch.int32, device=dev))
    size = ops.decode_mha_cache_size()
    for L in range(2, 12):
        ops.decode_mha(q, k, v, torch.tensor([L], dtype=torch.int32, device=dev))
    check(ops.decode_mha_cache_size() == size, f"decode_mha_cache_size grew "
          f"from {size} to {ops.decode_mha_cache_size()} over ten cache lengths")
    log(f"[decode] decode_mha_cache_size {size} after a launch at cache_len 1 "
        f"and {ops.decode_mha_cache_size()} after ten more at cache lengths "
        f"2-11 (B{B} H{H} KV{KV} S{S} D{D} bf16) on {card}")
    for H_, KV_ in ((8, 8), (16, 4)):  # G = 1 and G = 4, D 64
        q, k, v = operands(4, H_, KV_, 300, 64, torch.bfloat16)
        errs.append(held(f"G{H_ // KV_} D64 bf16", q, k, v, [0, 1, 129, 300]))
        q, k, v = operands(4, H_, KV_, 300, 64, torch.float32)
        errs.append(held(f"G{H_ // KV_} D64 fp32", q, k, v, [0, 1, 129, 300]))
    paged, paged_err = paged_check(dev, peaks, card)
    errs.append(paged_err)

    def times(q, k, v, L, tag, reps, burst=False):
        lt = torch.tensor([L], dtype=torch.int32, device=dev)
        Bq, Hq, Dq = q.shape
        kernel = lambda: ops.decode_mha(q, k, v, lt)  # noqa: E731
        ms = time_ms(kernel, reps=reps)
        plain_ms = time_ms(lambda: ref.decode_attention_ref(q, k, v, lt),
                           reps=reps)
        lib_ms = lib_err = call = None
        try:
            call = sdpa_call(q, k, v, L)
            lib_err = (call().float() - ops.decode_mha(q, k, v, lt)[0].float()
                       ).abs().max().item()
            lib_ms = time_ms(call, reps=reps)
        except (RuntimeError, NotImplementedError, ValueError) as e:
            log(f"  {tag}: library call refused: {type(e).__name__}: {e}")
        extra = {}
        if burst:
            extra = back_to_back("decode_attention", tag, kernel, call)
        b_ms, b_by, nbytes, flops = decode_bound(Bq, Hq, k.shape[1], L, Dq,
                                                 q.dtype, peaks)
        log(f"[time] decode_attention {tag}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, library "
            f"{lib_ms if lib_ms is None else f'{lib_ms:.4f}'} ms (max |library"
            f" - kernel| {lib_err}), bound {b_ms:.4f} ms by {b_by} "
            f"({nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP; "
            f"{nbytes / ms / 1e6:.1f} GB/s achieved) on {card}")
        return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                    bound_by=b_by, **extra)

    def sweep(q, k, v, L, tag, splits, graph):
        """The kernel at each split count (``ops.launch`` at a forced
        plan), held to the plain version, timed from a CUDA graph
        (``graph``) or as single calls; the plan's own count starred."""
        lt = torch.tensor([L], dtype=torch.int32, device=dev)
        want, want_lse = ref.decode_attention_ref(q, k, v, lt)
        plan = ops.plan_for(q, k)
        tiles = -(-k.shape[2] // tile)
        cells, ms = [], {}
        for n in sorted(set(splits) | {plan[0]}):
            forced = ops.split_plan(k.shape[2], q.shape[0] * k.shape[1], 0,
                                    n_split=n)
            if forced[0] in ms:  # n rounds to a count already timed
                continue
            out, lse = ops.launch(q, k, v, lt, forced)
            torch.testing.assert_close(out.float(), want.float(),
                                       **DECODE_TOL[q.dtype])
            torch.testing.assert_close(lse, want_lse, **DECODE_TOL[q.dtype])
            call = lambda: ops.launch(q, k, v, lt, forced)  # noqa: E731
            ms[forced[0]] = graph_ms(call) if graph else time_ms(call, reps=5)
            star = "*" if forced == plan else ""
            cells.append(f"{forced[0]}{star}: {ms[forced[0]]:.4f}")
        log(f"[sweep] decode_attention {tag} ({tiles} tiles of {tile} keys; "
            f"{'a launch from a CUDA graph' if graph else 'single calls'}), "
            f"ms by n_split: {', '.join(cells)} on {card}")
        return ms

    timing = times(*main[torch.bfloat16], PROMPT + NEW,
                   f"serving shape B{B} H{H} KV{KV} S{S} D{D} bf16 "
                   f"cache_len {PROMPT + NEW}", reps=20, burst=True)
    timing["split_sweep"] = sweep(*main[torch.bfloat16], PROMPT + NEW,
                                  "serving shape bf16", (1, 2, 3, 5, 8, 10),
                                  graph=True)
    timing["paged"] = paged
    del main
    # one long-cache layer: 4.29 GB of K and V
    LB, LS = LONG_BATCH, LONG_S
    q, k, v = operands(LB, H, KV, LS, D, torch.bfloat16)
    errs.append(held(f"long B{LB} KV{KV} S{LS} D{D} bf16", q, k, v, [LS]))
    long = times(q, k, v, LS, f"long cache B{LB} H{H} KV{KV} S{LS} D{D} bf16",
                 reps=10)
    timing["long_cache"] = dict(shape=[LB, H, KV, LS, D], **long)
    timing["long_cache"]["split_sweep"] = sweep(
        q, k, v, LS, "long cache bf16", (1, 4, 32), graph=False)
    del q, k, v
    torch.cuda.empty_cache()
    return timing, max(errs)


# ---------------------------------------------------------------------------
# 5. the serving path
# ---------------------------------------------------------------------------


def serve_phase(dev, card):
    """``ServingEngine`` at internlm2-1.8b's full width through the decode
    kernel, then against the plain backend.  Returns the decode kernel's
    launches on the path and the measured decode ms a step."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.serving.engine import ServingEngine

    cfg = get_config(ARCH)
    t = time.time()
    engine = ServingEngine(cfg, seed=SEED)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in engine.params.parameters())
    log(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads / {cfg.n_kv_heads} KV heads, d_head "
        f"{cfg.d_head}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size} padded to "
        f"{cfg.padded_vocab()}; {n_params / 1e9:.3f} B params in "
        f"{engine.params.embed.dtype} drawn on the card from seed {SEED} in "
        f"{time.time() - t:.1f} s; backend {engine.attn_backend.name}")
    rng = np.random.default_rng(1)
    prompts = rng.integers(0, cfg.vocab_size,
                           size=(SERVE_BATCH, PROMPT)).astype(np.int32)
    max_len = PROMPT + NEW
    engine.generate(prompts[:, :16], max_new_tokens=2)  # warm-up

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = engine.generate(prompts, max_new_tokens=NEW)
    t_first = time.perf_counter() - t
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    want = only(launches, decode_attention=cfg.n_layers * NEW)
    check(launches == want, f"serving launches {launches}, want {want}")
    V = cfg.padded_vocab()
    check(res.tokens.shape == (SERVE_BATCH, NEW)
          and bool(((res.tokens >= 0) & (res.tokens < V)).all()),
          f"tokens {res.tokens.shape} out of range")
    check(res.prefill_logits.shape == (SERVE_BATCH, V)
          and bool(np.isfinite(res.prefill_logits).all()),
          "last step's logits not finite")
    log(f"[serve] generate(B {SERVE_BATCH}, prompt {PROMPT}, {NEW} new): "
        f"{t_first:.3f} s host wall (first timed run); decode kernel launches "
        f"{launches['decode_attention']} = {cfg.n_layers} x {NEW}; peak device "
        f"memory {peak / 1e9:.2f} GB; first tokens {res.tokens[0, :8].tolist()}")

    def wall(n_new, reps=3):
        ts = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine.generate(prompts, max_new_tokens=n_new)
            ts.append(time.perf_counter() - t0)
        return statistics.median(ts)

    t_prefill, t_gen = wall(0), wall(NEW)
    step = (t_gen - t_prefill) / NEW
    log(f"[serve] prefill {t_prefill * 1e3:.2f} ms (median of 3 generate(..., "
        f"0)); generate {t_gen * 1e3:.2f} ms (median of 3); decode "
        f"{step * 1e3:.3f} ms/step, {SERVE_BATCH / step:.1f} tokens/s; "
        f"end to end {SERVE_BATCH * NEW / t_gen:.1f} tokens/s, on {card}")
    profile_decode(engine, prompts, step * 1e3)

    # Teacher-forced on the kernel run's tokens: the kernel against its plain
    # version on the card (the same math, p kept in fp32), and the
    # reference's two plain backends beside it, which round the
    # probabilities to bf16 before p @ v at other points.
    names = ("plain", "dense-ref", "chunked-lse")
    others = {n: ServingEngine(cfg, params=engine.params,
                               attn_backend=PlainSplitKOnCard() if n == "plain"
                               else n) for n in names}
    batch = {"tokens": torch.as_tensor(prompts, dtype=torch.int64, device=dev)}
    lk, ck = engine.model.prefill(engine.params, batch, max_len)
    caches = {}
    for n, e in others.items():
        lo, caches[n] = e.model.prefill(e.params, batch, max_len)
        check(torch.equal(lk, lo), f"prefill logits differ under {n}")
    toks = torch.as_tensor(res.tokens, dtype=torch.int64, device=dev)
    pairs = [("kernel", n) for n in names] + [("dense-ref", "chunked-lse")]
    stats = {pr: dict(max_abs=0.0, outside=0.0, rel_l2=0.0) for pr in pairs}
    agree = {n: 0 for n in names}
    replay = 0
    for t in range(NEW):
        tok = toks[:, t:t + 1]
        lk, ck = engine.model.decode_step(engine.params, tok, ck)
        lo = {"kernel": lk}
        for n, e in others.items():
            lo[n], caches[n] = e.model.decode_step(e.params, tok, caches[n])
        for a, b in pairs:
            d = (lo[a] - lo[b]).abs()
            st = stats[(a, b)]
            st["max_abs"] = max(st["max_abs"], d.max().item())
            bound = LOGITS_TOL["atol"] + LOGITS_TOL["rtol"] * lo[b].abs()
            st["outside"] = max(st["outside"], (d > bound).float().mean().item())
            st["rel_l2"] = max(st["rel_l2"], (d.norm() / lo[b].norm()).item())
        outside = stats[("kernel", "plain")]["outside"]
        check(outside <= LOGITS_OUTSIDE_MAX,
              f"step {t}: {outside:.3%} of the logits differ from the plain "
              f"version's by more than rtol=atol=3e-2")
        if t + 1 < NEW:
            replay += int((lk[:, 0].argmax(-1) == toks[:, t + 1]).sum())
            for n in names:
                agree[n] += int((lo[n][:, 0].argmax(-1) == toks[:, t + 1]).sum())
    n_next = SERVE_BATCH * (NEW - 1)
    check(replay == n_next, f"the kernel's teacher-forced replay picked "
                            f"{replay} of {n_next} tokens again")
    check(np.array_equal(lk[:, 0].cpu().numpy(), res.prefill_logits),
          "replayed last-step logits differ from generate's")
    check(agree["plain"] >= AGREE_MIN * n_next,
          f"the plain version's greedy next tokens agree on only "
          f"{agree['plain']} of {n_next}")
    log(f"[serve] bf16 teacher-forced, {NEW} steps, logits std "
        f"{lk.float().std().item():.3f} (last step); worst step of each pair: "
        "max |diff|, share of logits outside rtol=atol=3e-2, |diff|_2/|logits|_2")
    for (a, b), st in stats.items():
        log(f"  {a} vs {b}: {st['max_abs']:.3e}, {st['outside']:.4%}, "
            f"{st['rel_l2']:.3e}")
    log(f"  greedy next tokens equal to the kernel run's, of {n_next}: "
        + ", ".join(f"{n} {agree[n]}" for n in names)
        + f" (kernel vs plain must be <= {LOGITS_OUTSIDE_MAX:.0%} outside, "
        f">= {AGREE_MIN:.0%} agreeing)")
    del ck, caches, lk, lo, others

    # fp32 copies of the same params: identical greedy tokens
    p32 = transformer.Transformer(cfg, dtype=torch.float32, device=dev)
    for dst, src in zip(p32.parameters(), engine.params.parameters()):
        dst.copy_(src)
    del engine
    torch.cuda.empty_cache()
    outs = {}
    for name in ("torch-splitk", "dense-ref"):
        outs[name] = ServingEngine(cfg, params=p32, attn_backend=name).generate(
            prompts, max_new_tokens=NEW_FP32)
    a, b = outs["torch-splitk"], outs["dense-ref"]
    check(np.array_equal(a.tokens, b.tokens),
          f"fp32 tokens differ: {a.tokens} vs {b.tokens}")
    err32 = float(np.abs(a.prefill_logits - b.prefill_logits).max())
    np.testing.assert_allclose(a.prefill_logits, b.prefill_logits, rtol=1e-4,
                               atol=1e-4)
    log(f"[serve] fp32 params, {NEW_FP32} new tokens: torch-splitk and "
        f"dense-ref tokens identical; last-step max |logits diff| {err32:.3e} "
        f"(tolerance 1e-4)")
    return launches["decode_attention"], step * 1e3


def device_rows(prof):
    """The profiler's device-side rows, largest first, as (name, device us
    in all, count)."""
    rows = [(e.key, getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0.0)), e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    return sorted(rows, key=lambda r: r[1], reverse=True)


def profile_decode(engine, prompts, step_ms: float, steps: int = 4,
                   kernel: str = "decode_attention", extra=None):
    """Device time by kernel over ``steps`` decode steps after a prefill
    (of ``prompts`` and the frontend's ``extra``), from ``torch.profiler``;
    says so where the profiler saw no device time.  ``step_ms`` is the
    unprofiled step time, for the busy share; ``kernel`` names the
    hand-written kernel whose share is reported (``None`` where the step
    launches none).  Returns the step's device ms, kernels and busy share,
    or None where not measured."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving.engine import extra_tensors

    dev = engine.device
    batch = {"tokens": torch.as_tensor(prompts, dtype=torch.int64, device=dev),
             **extra_tensors(extra, dev)}
    logits, cache = engine.model.prefill(
        engine.params, batch,
        prompts.shape[1] + NEW + (engine.cfg.frontend_tokens or 0))
    token = logits[:, -1:].argmax(dim=-1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(steps):
            logits, cache = engine.model.decode_step(engine.params, token, cache)
            token = logits[:, -1:].argmax(dim=-1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3 / steps
    rows = device_rows(prof)
    total = sum(us for _, us, _ in rows) / 1e3 / steps
    if total <= 0:
        log("[profile] no device time in the profiler's trace: not measured")
        return None
    n_kernels = sum(n for _, _, n in rows) / steps
    if kernel is None:
        share = "no hand-written kernel in the step"
    else:
        dec = sum(us for key, us, _ in rows if kernel in key) / 1e3 / steps
        share = (f"{kernel} kernel {dec:.4f} ms ({100 * dec / total:.2f}% of "
                 f"device time, {100 * dec / step_ms:.2f}% of the step)")
    log(f"[profile] {engine.cfg.name}, {steps} decode steps (B "
        f"{prompts.shape[0]}, after a prompt of {prompts.shape[1]}): per step "
        f"{total:.3f} ms device time over {n_kernels:.0f} kernels, "
        f"{wall_ms:.2f} ms host wall under the profiler; device busy "
        f"{100 * total / step_ms:.1f}% of the unprofiled {step_ms:.2f} ms "
        f"step; {share}")
    for key, us, n in rows[:10]:
        log(f"  {us / 1e3 / steps:9.4f} ms/step  {n / steps:6.1f}"
            f" x/step  {key[:80]}")
    return dict(device_ms=total, kernels=n_kernels, busy=total / step_ms)


class PlainSplitKOnCard:
    """The decode kernel's plain version (``ref.decode_attention_ref``: the
    TPU kernel's math, p kept in fp32) as an attention backend on the
    card's tensors, with the kernel backend's cache layout.  Used only to
    hold the kernel to it."""

    name = "torch-splitk-plain"

    def __init__(self):
        from repro_torch.core.backends import TorchSplitKAttention

        # the padding rule does not depend on the device
        self.layout_of = TorchSplitKAttention(device="cpu")

    def cache_layout(self, max_len):
        return self.layout_of.cache_layout(max_len)

    def decode(self, q, k_cache, v_cache, cache_len):
        from repro_torch.kernels.decode_attention import ref

        B, _, H, D = q.shape
        out, _ = ref.decode_attention_ref(q.reshape(B, H, D), k_cache,
                                          v_cache, cache_len)
        return out[:, None]


# ---------------------------------------------------------------------------
# 5b. continuous batching: per-row lengths, the paged pool, the graphed step
# ---------------------------------------------------------------------------


def cb_requests(n: int, prompts, budgets, arrivals: int, vocab: int, seed: int):
    """``n`` requests with prompt lengths and budgets drawn uniformly from
    the inclusive ranges ``prompts`` and ``budgets``, and arrival steps
    from 0 to ``arrivals``."""
    from repro_torch.serving.scheduler import Request

    rng = np.random.default_rng(seed)
    return [Request(rid=i,
                    prompt=rng.integers(0, vocab, int(rng.integers(
                        prompts[0], prompts[1] + 1))).astype(np.int32),
                    max_new_tokens=int(rng.integers(budgets[0], budgets[1] + 1)),
                    arrival=int(rng.integers(0, arrivals + 1)))
            for i in range(n)]


def drive(sched, reqs):
    """Serve ``reqs`` through the scheduler ``sched``.  Returns (results by
    rid, host wall in s, each decode step's ms between two CUDA events
    around it)."""
    events = []

    def step(launch):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        launch()
        e1.record()
        events.append((e0, e1))

    torch.cuda.synchronize()
    t = time.perf_counter()
    res = sched.run(reqs, around_step=step)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    return ({r.rid: r for r in res}, wall, [a.elapsed_time(b) for a, b in events])


def traced_launches(sched, reqs, kernel: str):
    """Serve ``reqs`` through ``sched`` under ``torch.profiler`` (device
    activity only) and count the device kernels whose name holds
    ``kernel`` in its trace: a replayed CUDA graph's kernels appear there
    one by one.  Returns (results by rid, the count, seconds the trace took
    to read)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        res = sched.run(reqs)
        torch.cuda.synchronize()
    # the trace's raw events: key_averages() builds a tree of ~200k events
    # first, which took 25 s at the stream's size
    t = time.perf_counter()
    n = sum(1 for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA
            and kernel in e.name())
    return {r.rid: r for r in res}, n, time.perf_counter() - t


def same_results(a: dict, b: dict, what: str) -> None:
    check(sorted(a) == sorted(b), f"{what}: rids {sorted(a)} vs {sorted(b)}")
    for rid in a:
        check(np.array_equal(a[rid].tokens, b[rid].tokens)
              and np.array_equal(a[rid].final_logits, b[rid].final_logits),
              f"{what}: request {rid} differs (tokens {a[rid].tokens[:8]} vs "
              f"{b[rid].tokens[:8]}, max |logits diff| "
              f"{np.abs(a[rid].final_logits - b[rid].final_logits).max()})")


def static_slot_steps(reqs, slots: int) -> int:
    """Slot-steps of padded static batching of the same width: the requests
    in arrival order, ``slots`` at a time, each batch decoding until its
    longest budget."""
    order = sorted(reqs, key=lambda r: (r.arrival, r.rid))
    return sum(max(r.max_new_tokens for r in order[i:i + slots]) * slots
               for i in range(0, len(order), slots))


def per_row_kernel(dev, card) -> float:
    """The decode kernel with one length per row (``CB_LENS``, and
    reversed) at the serving shape against its plain version, and each row
    bit for bit the launch of its own length alone; both timed from a CUDA
    graph beside one shared length.  Returns the max error."""
    from repro_torch.kernels.decode_attention import ops, ref

    B, H, KV, S, D = DECODE_SHAPE
    check(len(CB_LENS) == B == CB_SLOTS, "CB_LENS must give every row a length")
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    lens = torch.tensor(CB_LENS, dtype=torch.int32, device=dev)
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = [torch.randn(shape, generator=gen, device=dev, dtype=dtype)
                   for shape in ((B, H, D), (B, KV, S, D), (B, KV, S, D))]
        tol = DECODE_TOL[dtype]
        for rows in (lens, lens.flip(0).contiguous()):
            out, lse = ops.decode_mha(q, k, v, rows)
            want, want_lse = ref.decode_attention_ref(q, k, v, rows)
            torch.testing.assert_close(out.float(), want.float(), **tol)
            torch.testing.assert_close(lse, want_lse, **tol)
            err = (out.float() - want.float()).abs().max().item()
            worst = max(worst, err)
            for b in range(B):
                o1, l1 = ops.decode_mha(q, k, v, rows[b:b + 1])
                check(torch.equal(out[b], o1[b]) and torch.equal(lse[b], l1[b]),
                      f"row {b} (cache_len {int(rows[b])}) differs from the "
                      f"launch of its length alone")
            log(f"  decode per-row lengths {rows.tolist()} {dtype}: max_abs_err "
                f"out {err:.3e}, lse {(lse - want_lse).abs().max().item():.3e} "
                f"(tolerance rtol=atol={tol['atol']}); every row bit for bit "
                f"its own length's launch")
        shared = torch.tensor([PROMPT + NEW], dtype=torch.int32, device=dev)
        t_rows = graph_ms(lambda: ops.decode_mha(q, k, v, lens))
        t_one = graph_ms(lambda: ops.decode_mha(q, k, v, shared))
        log(f"[time] decode_attention B{B} H{H} KV{KV} S{S} D{D} {dtype}, a "
            f"launch from a CUDA graph: per-row lengths {CB_LENS} {t_rows:.4f} "
            f"ms, one length {PROMPT + NEW} {t_one:.4f} ms, on {card}")
    return worst


def admission_ms(sched, req) -> float:
    """The median host wall of ``CB_ADMIT_REPS`` admissions of ``req`` into
    the vacant scheduler ``sched``, each from an idle card until its work
    is done, each followed by the request's retirement (untimed)."""
    ts = []
    for _ in range(CB_ADMIT_REPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        sched._admit(req, 0, 0)
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t) * 1e3)
        sched._retire(0)
    return statistics.median(ts)


def cb_prefill_check(engine, dev, card) -> dict:
    """The padded prefill's CUDA graphs at the benchmark cell's slot
    capacity (``CB_CELL_CAP``, all eight buckets), bf16 at full width: a
    stream over the cell's prompt lengths through the scheduler with the
    graphs and through ``graph=False`` (the same padded prefill, eagerly),
    bit for bit equal; each prompt's first token and logits
    teacher-forced, the padded graph's against the unpadded prefill (the
    dense gate: at most ``LOGITS_OUTSIDE_MAX`` of the logits outside
    ``LOGITS_TOL``, at least ``AGREE_MIN`` of the first tokens equal); 4
    requests each bit for bit itself alone; one capture a bucket and one
    replay an admission; then ``[time]`` lines for an admission of ``CB_ADMIT_LENS`` tokens graphed
    and eager.  Returns the numbers."""
    import dataclasses

    from repro_torch.serving.scheduler import (
        Request,
        RequestScheduler,
        prefill_buckets,
    )

    cfg = engine.cfg
    layout = engine.cache_layout(CB_CELL_CAP)
    cap = layout.padded_len(CB_CELL_CAP)
    buckets = prefill_buckets(cap)
    n, prompts, budgets, arrivals = CB_CELL_STREAM
    reqs = cb_requests(n, prompts, budgets, arrivals, cfg.vocab_size, SEED + 3)

    def scheduler(graph):
        return RequestScheduler(engine.model, engine.params, CB_SLOTS, cap,
                                layout=layout, device=dev, graph=graph)

    t = time.perf_counter()
    graphed = scheduler(True)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t
    check(graphed.captures == 1
          and graphed.prefill_captures == len(buckets),
          f"{graphed.prefill_captures} prefill graphs for buckets {buckets}, "
          f"{graphed.captures} step graphs")
    res_g, wall_g, _ = drive(graphed, reqs)
    check(graphed.prefill_replays == len(reqs),
          f"{graphed.prefill_replays} prefill replays for {len(reqs)} admissions")
    eager = scheduler(False)
    res_e, wall_e, _ = drive(eager, reqs)
    check(eager.prefill_captures == eager.prefill_replays == 0,
          "the eager scheduler captured or replayed a prefill graph")
    same_results(res_g, res_e, "padded prefill graph vs eager")
    for r in reqs[:CB_SOLO]:
        solo = {x.rid: x for x in graphed.run([dataclasses.replace(r, arrival=0)])}
        same_results({r.rid: res_g[r.rid]}, solo, "padded stream vs solo")
    check(graphed.prefill_replays == len(reqs) + CB_SOLO,
          f"{graphed.prefill_replays} replays, want {len(reqs) + CB_SOLO}")

    outside = worst = 0.0
    agree = 0
    for r in reqs:
        lg = graphed._prefill(r)[0].clone()
        batch = {"tokens": torch.as_tensor(np.asarray(r.prompt, np.int64)[None],
                                           device=dev)}
        le = engine.model.prefill(engine.params, batch, cap)[0]
        d = (lg - le).abs()
        bound = LOGITS_TOL["atol"] + LOGITS_TOL["rtol"] * le.abs()
        outside = max(outside, (d > bound).float().mean().item())
        worst = max(worst, d.max().item())
        agree += int(torch.equal(lg.argmax(-1), le.argmax(-1)))
    check(outside <= LOGITS_OUTSIDE_MAX,
          f"{outside:.3%} of a prompt's logits differ between the padded "
          f"graph and the unpadded prefill by more than rtol=atol=3e-2")
    check(agree >= AGREE_MIN * len(reqs),
          f"first tokens equal in only {agree} of {len(reqs)} prompts")
    tokens = sum(r.max_new_tokens for r in reqs)
    log(f"[stream] padded prefill at capacity {cap} (buckets {buckets}): "
        f"{len(reqs)} requests, prompts {[len(r.prompt) for r in reqs]}, "
        f"budgets {[r.max_new_tokens for r in reqs]}; scheduler built, "
        f"{graphed.prefill_captures} prefill graphs and 1 step graph "
        f"captured in {t_build:.2f} s; prefill replays {graphed.prefill_replays}"
        f" = {len(reqs)} admissions + {CB_SOLO} solo; teacher-forced prefill, "
        f"graph vs unpadded eager: max |logits diff| {worst:.3e}, at most "
        f"{outside:.4%} outside rtol=atol=3e-2, first tokens equal "
        f"{agree}/{len(reqs)}; graph and eager streams bit for bit equal; "
        f"{CB_SOLO} requests bit for bit themselves alone; stream "
        f"wall graph {wall_g:.3f} s ({tokens / wall_g:.1f} tokens/s), eager "
        f"{wall_e:.3f} s ({tokens / wall_e:.1f} tokens/s), on {card}")

    out = dict(capacity=cap, buckets=buckets, build_s=t_build,
               logits_max_diff=worst, logits_outside=outside,
               first_tokens_equal=agree,
               wall_s_graph=wall_g, wall_s_eager=wall_e)
    rng = np.random.default_rng(SEED + 4)
    for S in CB_ADMIT_LENS:
        req = Request(rid=0, prompt=rng.integers(0, cfg.vocab_size, S)
                      .astype(np.int32), max_new_tokens=1)
        ms_g, ms_e = admission_ms(graphed, req), admission_ms(eager, req)
        log(f"[time] admission of a {S}-token prompt (prefill at bucket "
            f"{[b for b in buckets if b >= S][0]}, pages, uploads), host wall "
            f"from an idle card to done, median of {CB_ADMIT_REPS}: graphed "
            f"{ms_g:.3f} ms, eager {ms_e:.3f} ms ({ms_e / ms_g:.2f}x), on {card}")
        out[f"admit_ms_{S}"] = dict(graph=ms_g, eager=ms_e)
    del graphed, eager
    torch.cuda.empty_cache()
    return out


def cb_phase(dev, card):
    """Continuous batching at internlm2-1.8b's full width (24 layers, bf16
    params from seed 0, ``torch-splitk``): the per-row decode kernel, then
    the ragged stream graphed and eager (bit for bit the same), its
    launches (the paged form's), capture count, ``gather_steps`` (0), step
    times, the decode steps' tokens/s and slot-steps, then fp32 requests
    against solo
    runs and ``generate``.  Returns (the decode kernel's launches in the
    profiler's trace of the graphed stream, the per-row check's max error,
    the stream's numbers)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.scheduler import (
        WARMUP_STEPS,
        RequestScheduler,
        prefill_buckets,
    )

    err = per_row_kernel(dev, card)
    cfg = get_config(ARCH)
    engine = ServingEngine(cfg, seed=SEED)
    layout = engine.cache_layout(CB_MAX_LEN)
    cap = layout.padded_len(CB_MAX_LEN)
    check(cap == DECODE_SHAPE[3], f"slot capacity {cap}, want {DECODE_SHAPE[3]}")
    reqs = cb_requests(CB_REQUESTS, CB_PROMPTS, CB_BUDGETS, CB_ARRIVALS,
                       cfg.vocab_size, SEED)

    def scheduler(params, graph):
        return RequestScheduler(engine.model, params, CB_SLOTS, cap,
                                layout=layout, device=dev, graph=graph)

    reset_counts()
    t = time.perf_counter()
    sched = scheduler(engine.params, True)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t
    pool = sched.pool
    pool_bytes = sum(b.numel() * b.element_size() for b in
                     (pool.buffers["k"], pool.buffers["v"]))
    log(f"[stream] {cfg.name} at full width, {engine.attn_backend.name}: "
        f"{CB_REQUESTS} requests, prompts {[len(r.prompt) for r in reqs]}, "
        f"budgets {[r.max_new_tokens for r in reqs]}, arrivals "
        f"{[r.arrival for r in reqs]}; {CB_SLOTS} slots of capacity {cap}, "
        f"pages of {layout.block_k} tokens, {pool.num_blocks} pages "
        f"({pool_bytes / 1e9:.2f} GB of K and V); scheduler built, step "
        f"warmed up and captured in {t_build:.2f} s")
    res_g, _, ms_g = drive(sched, reqs)
    # the wrapper counts the launches it makes: the warm-up's and the ones
    # the capture records; the replays run the graph, not the wrapper
    built = read_counts()
    want = only(built, decode_attention_paged=cfg.n_layers * (WARMUP_STEPS + 1))
    check(built == want, f"graphed stream's wrapper launches {built}, want {want}")
    steps = sched.steps_run
    # The profiler can lose a few of the ~243k device events of a traced
    # stream (once, 9 short, in 9 traces of it): a trace short of the count
    # is taken again, up to TRACE_ATTEMPTS times; one must hold exactly
    # 24 x steps, and none may hold more.
    streams = 1
    for attempt in range(TRACE_ATTEMPTS):
        res_t, traced, t_read = traced_launches(sched, reqs,
                                                "decode_attention_kernel")
        streams += 1
        check(traced <= cfg.n_layers * steps,
              f"{traced} decode kernels in the trace of the graphed stream, "
              f"more than {cfg.n_layers} x {steps}")
        if traced == cfg.n_layers * steps:
            break
        log(f"[stream] trace {attempt + 1} held {traced} decode kernels, "
            f"{cfg.n_layers * steps - traced} short of {cfg.n_layers} x "
            f"{steps}: tracing the stream again")
    check(traced == cfg.n_layers * steps,
          f"{traced} decode kernels in the trace of the graphed stream, want "
          f"{cfg.n_layers} x {steps}")
    same_results(res_g, res_t, "graph vs graph under the profiler")
    check(sched.captures == 1, f"{sched.captures} captures over the stream")
    check(pool.allocator.live_blocks == 0, "pages still live after the stream")
    V = cfg.padded_vocab()
    for r in reqs:
        got = res_g[r.rid]
        check(got.tokens.shape == (r.max_new_tokens,)
              and bool(((got.tokens >= 0) & (got.tokens < V)).all())
              and got.final_logits.shape == (V,)
              and bool(np.isfinite(got.final_logits).all()),
              f"request {r.rid}: tokens {got.tokens.shape} or logits wrong")
    eager = scheduler(engine.params, False)
    reset_counts()
    res_e, _, ms_e = drive(eager, reqs)
    launches = read_counts()
    want = only(launches, decode_attention_paged=cfg.n_layers * steps)
    check(launches == want, f"eager stream launches {launches}, want {want}")
    check(sched.gather_steps == eager.gather_steps == 0,
          f"gather_steps {sched.gather_steps} graphed, {eager.gather_steps} "
          f"eager: the single-device step gathered the pool")
    same_results(res_g, res_e, "graph vs eager")
    check(eager.steps_run == steps and eager.captures == 0, "eager steps differ")
    check(sched.captures == 1, f"{sched.captures} captures over {streams} streams")
    n_buckets = len(prefill_buckets(cap))
    check(sched.prefill_captures == n_buckets
          and sched.prefill_replays == streams * len(reqs),
          f"prefill graphs: {sched.prefill_captures} captured (want "
          f"{n_buckets}), {sched.prefill_replays} replays over {streams} "
          f"streams of {len(reqs)} admissions")
    tokens = sum(r.max_new_tokens for r in reqs)
    check(sched.tokens_emitted == streams * tokens, "tokens emitted != the budgets")
    static = static_slot_steps(reqs, CB_SLOTS)
    med_g, med_e = statistics.median(ms_g), statistics.median(ms_e)
    log(f"[stream] {steps} decode steps, {tokens} tokens; decode kernels in "
        f"the profiler's trace of the graphed stream {traced} = "
        f"{cfg.n_layers} x {steps} (trace read in {t_read:.2f} s); wrapper "
        f"launches of the paged form: {built['decode_attention_paged']} "
        f"building the graph ({WARMUP_STEPS} warm-up steps and the capture), "
        f"{launches['decode_attention_paged']} on the eager stream; captures "
        f"{sched.captures} (over {streams} streams), prefill graphs "
        f"{sched.prefill_captures} (one a bucket of {prefill_buckets(cap)}), "
        f"{sched.prefill_replays} replays = {streams} x {len(reqs)} "
        f"admissions, gather_steps {sched.gather_steps} of "
        f"{sched.steps_run}; graph and eager tokens and final logits bit for "
        f"bit equal")
    log(f"[stream] ms a step (median between CUDA events): graph {med_g:.3f}, "
        f"eager {med_e:.3f} ({med_e / med_g:.2f}x); decode steps alone: "
        f"graph {tokens / sum(ms_g) * 1e3:.1f} tokens/s, eager "
        f"{tokens / sum(ms_e) * 1e3:.1f} tokens/s, on {card}")
    log(f"[stream] slot-steps: continuous {steps * CB_SLOTS} ({steps} steps x "
        f"{CB_SLOTS}), padded static batching {static}; {tokens} tokens")
    check(steps * CB_SLOTS < static, "continuous batching spent no fewer "
                                     "slot-steps than padded static batches")
    summary = dict(steps=steps, tokens=tokens, step_ms_graph=med_g,
                   step_ms_eager=med_e, gather_steps=sched.gather_steps,
                   slot_steps=steps * CB_SLOTS, static_slot_steps=static)
    del sched, eager, pool
    torch.cuda.empty_cache()
    summary["prefill"] = cb_prefill_check(engine, dev, card)

    # fp32 copies of the params: CB_SOLO requests against each alone
    # through the same scheduler (bit for bit) and generate at B 1
    p32 = transformer.Transformer(cfg, dtype=torch.float32, device=dev)
    for dst, src in zip(p32.parameters(), engine.params.parameters()):
        dst.copy_(src)
    del engine
    torch.cuda.empty_cache()
    e32 = ServingEngine(cfg, params=p32)
    s32 = RequestScheduler(e32.model, p32, CB_SLOTS, cap, layout=layout,
                           device=dev)
    sub = reqs[:CB_SOLO]
    stream = {r.rid: r for r in s32.run(sub)}
    worst = 0.0
    for r in sub:
        solo = {x.rid: x for x in s32.run([dataclasses.replace(r, arrival=0)])}
        same_results({r.rid: stream[r.rid]}, solo, "fp32 stream vs solo")
        g = e32.generate(np.asarray(r.prompt)[None], r.max_new_tokens,
                         max_len=cap)
        check(np.array_equal(g.tokens[0], stream[r.rid].tokens),
              f"request {r.rid}: stream tokens differ from generate's")
        np.testing.assert_allclose(stream[r.rid].final_logits,
                                   g.prefill_logits[0], rtol=1e-4, atol=1e-4)
        worst = max(worst, float(np.abs(stream[r.rid].final_logits
                                        - g.prefill_logits[0]).max()))
    check(s32.captures == 1, f"{s32.captures} captures over {1 + CB_SOLO} streams")
    check(s32.prefill_replays == 2 * len(sub),
          f"{s32.prefill_replays} prefill replays, want {2 * len(sub)}")
    log(f"[stream] fp32 params, requests {[r.rid for r in sub]} (prompts "
        f"{[len(r.prompt) for r in sub]}, budgets "
        f"{[r.max_new_tokens for r in sub]}): each bit for bit the same "
        f"request alone through the same scheduler; tokens identical to "
        f"generate at B 1, max |logits diff| {worst:.3e} (tolerance 1e-4); "
        f"captures {s32.captures} over {1 + CB_SOLO} streams")
    del s32, e32, p32
    torch.cuda.empty_cache()
    return traced, err, summary


def cb_ssm(engine, dev, card) -> None:
    """mamba2-370m's shorter stream (``CB_SSM``), graphed: it launches no
    hand-written kernel, and each request's tokens and logits equal it
    served alone through the same scheduler, bit for bit; then eager."""
    import dataclasses

    from repro_torch.serving.scheduler import RequestScheduler

    n, slots, prompts, budgets = CB_SSM
    cfg = engine.cfg
    reqs = cb_requests(n, prompts, budgets, 8, cfg.vocab_size, SEED)
    max_len = prompts[1] + budgets[1]
    layout = engine.cache_layout(max_len)
    cap = layout.padded_len(max_len)

    def scheduler(graph):
        return RequestScheduler(engine.model, engine.params, slots, cap,
                                layout=layout, device=dev, graph=graph)

    sched = scheduler(True)
    reset_counts()
    res, wall, ms = drive(sched, reqs)
    launches = read_counts()
    check(launches == only(launches), f"mamba2 stream launches {launches}")
    steps, tokens = sched.steps_run, sched.tokens_emitted
    for r in reqs:
        solo = {x.rid: x for x in sched.run([dataclasses.replace(r, arrival=0)])}
        same_results({r.rid: res[r.rid]}, solo, "mamba2 stream vs solo")
    check(sched.captures == 1, f"{sched.captures} captures")
    res_e, wall_e, ms_e = drive(scheduler(False), reqs)
    same_results(res, res_e, "mamba2 graph vs eager")
    log(f"[stream] {cfg.name}: {n} requests (prompts {[len(r.prompt) for r in reqs]}, "
        f"budgets {[r.max_new_tokens for r in reqs]}) through {slots} slots: "
        f"{steps} steps, {tokens} tokens, no hand-written kernel launched; "
        f"each request bit for bit itself served alone; graph = eager bit for "
        f"bit; ms a step graph {statistics.median(ms):.3f}, eager "
        f"{statistics.median(ms_e):.3f}; stream wall graph {wall:.3f} s "
        f"({tokens / wall:.1f} tokens/s), eager {wall_e:.3f} s "
        f"({tokens / wall_e:.1f} tokens/s); captures {sched.captures}, on {card}")


# ---------------------------------------------------------------------------
# 15. the sequence-sharded stream (generate_stream(mesh=...))
# ---------------------------------------------------------------------------


def mesh_of(d: int, dev):
    """``d`` sequence shards, all on the card: ``[cuda:0] * d``."""
    from repro_torch.launch.mesh import make_mesh

    return make_mesh((d,), ("seq",), [dev] * d)


def shard_list(t: torch.Tensor, d: int) -> list:
    """``t [B, KV, S, D]`` split along S into ``d`` contiguous shards."""
    return [c.contiguous() for c in t.chunk(d, dim=2)]


def sharded_op_check(engine, dev, card) -> dict:
    """``sharded_decode_attend`` on layer 0's real q, K and V (8 prompts of
    ``PROMPT`` prefilled at the mesh capacity, the next token's q, k, v,
    each row at its own position ``MESH_POS``) against the unsharded
    kernel call on the same cache, at D 2 and D 4, in bf16 and widened to
    fp32; each shard's kernel launch against its plain version at the
    shard's shape; the lse merge timed.  Returns the numbers."""
    from repro_torch.kernels.decode_attention import ops, ref
    from repro_torch.models import attention
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as TF

    cfg = engine.cfg
    rng = np.random.default_rng(2)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size, (SERVE_BATCH, PROMPT)),
                              device=dev)
    logits, cache = engine.model.prefill(engine.params, {"tokens": prompts},
                                         MESH_CAP)
    blk = engine.params.blocks[0]
    pos = torch.tensor(MESH_POS, dtype=torch.int32, device=dev)
    x = L.embed_tokens(engine.params.embed, logits[:, -1:].argmax(-1))
    hn = L.rms_norm(x, blk.ln_attn, cfg.norm_eps)
    q, k, v = L.qkv_project(blk.attn, hn)
    q = L.apply_rope(q, pos.reshape(-1, 1), cfg.rope_theta)
    k = L.apply_rope(k, pos.reshape(-1, 1), cfg.rope_theta)
    B, _, KV, D = k.shape
    H = q.shape[2]
    rows = torch.arange(B, device=dev)
    attn = engine.attn_backend
    out = dict(errs={}, shard_errs={})
    for dtype in (torch.bfloat16, torch.float32):
        qq = q.to(dtype)
        kn, vn = (t.to(dtype).reshape(B, KV, 1, D) for t in (k, v))
        full_k, full_v = (cache[key][0].to(dtype, copy=True) for key in ("k", "v"))
        full_k[rows, :, pos.long()] = kn[:, :, 0]
        full_v[rows, :, pos.long()] = vn[:, :, 0]
        want, _ = ops.decode_mha(qq.reshape(B, H, D), full_k, full_v, pos + 1)
        for d in MESH_DS[1:]:
            ks = shard_list(cache["k"][0].to(dtype), d)
            vs = shard_list(cache["v"][0].to(dtype), d)
            got, ks, vs = attention.sharded_decode_attend(
                attn, qq, kn, vn, ks, vs, pos, mesh_of(d, dev))
            check(torch.equal(torch.cat(ks, dim=2), full_k)
                  and torch.equal(torch.cat(vs, dim=2), full_v),
                  f"D {d} {dtype}: the shards' K and V are not the unsharded "
                  f"cache with the token written at its position")
            err = (got[:, 0] - want.float()).abs().max().item()
            torch.testing.assert_close(got[:, 0], want.float(), **DECODE_TOL[dtype])
            out["errs"][f"D{d}_{dtype}"] = err
            s_loc = MESH_CAP // d
            worst = 0.0
            for i, (kc, vc) in enumerate(zip(ks, vs)):
                lens = (pos + 1 - i * s_loc).clamp(0, s_loc).to(torch.int32)
                o, lse = ops.decode_mha(qq.reshape(B, H, D), kc, vc, lens)
                wo, wl = ref.decode_attention_ref(qq.reshape(B, H, D), kc, vc, lens)
                torch.testing.assert_close(o.float(), wo.float(), **DECODE_TOL[dtype])
                torch.testing.assert_close(lse, wl, **DECODE_TOL[dtype])
                worst = max(worst, (o.float() - wo.float()).abs().max().item())
            out["shard_errs"][f"D{d}_{dtype}"] = worst
            log(f"[stream-mesh] op level, layer 0's real q, K, V (B {B}, H {H}, "
                f"KV {KV}, S {MESH_CAP} = {d} x {s_loc}, D {D}, rows at "
                f"positions {MESH_POS}), {dtype}: sharded_decode_attend vs the "
                f"unsharded kernel call max |diff| {err:.3e} (tolerance "
                f"{DECODE_TOL[dtype]['atol']}); the token on its owner only; "
                f"each shard's kernel launch vs its plain version max_abs_err "
                f"{worst:.3e}")
    # the merge of D 4 partials at this shape, timed
    d = MESH_DS[-1]
    s_loc = MESH_CAP // d
    ks = shard_list(cache["k"][0], d)
    vs = shard_list(cache["v"][0], d)
    parts = [attn.decode_partial(q, kc, vc, (pos + 1 - i * s_loc).clamp(
        0, s_loc).to(torch.int32)) for i, (kc, vc) in enumerate(zip(ks, vs))]
    outs, lses = [p[0] for p in parts], [p[1] for p in parts]
    c_b2b, c_graph, c_dev = burst_ms(
        lambda: attention.combine_split_kv(outs, lses), n=20, reps=3)
    log(f"[stream-mesh] the lse merge of {d} partials ([{B}, 1, {H}, {D}] "
        f"each): {c_b2b:.4f} ms back to back, {c_graph:.4f} from a CUDA "
        f"graph, {fmt_ms(c_dev)} ms of device time a merge, {cfg.n_layers} a "
        f"step, on {card}")
    out.update(combine_b2b_ms=c_b2b, combine_graph_ms=c_graph,
               combine_device_ms=c_dev)
    del cache, parts, outs, lses, ks, vs
    torch.cuda.empty_cache()
    return out


def sharded_teacher_forced(engine, dev, card) -> dict:
    """The dense serving gate (phase 5's) for the sharded step: ``generate``
    at the mesh capacity for 8 prompts of ``PROMPT`` (32 new tokens), then,
    teacher-forced on those tokens, ``decode_step`` over the prefilled
    cache split into D shards (``seq_shard_axes``) against the unsharded
    step on the same cache, for D 2 and 4: >= ``AGREE_MIN`` of greedy next
    tokens equal; the worst step's share of logits outside rtol=atol=3e-2
    reported.  (A free-running stream carries one early flip through the
    rest of its request, so its share of equal tokens is reported, not
    gated.)"""
    cfg = engine.cfg
    rng = np.random.default_rng(3)
    prompts = rng.integers(0, cfg.vocab_size,
                           size=(SERVE_BATCH, PROMPT)).astype(np.int32)
    res = engine.generate(prompts, max_new_tokens=NEW, max_len=MESH_CAP)
    batch = {"tokens": torch.as_tensor(prompts, dtype=torch.int64, device=dev)}
    _, base = engine.model.prefill(engine.params, batch, MESH_CAP)
    toks = torch.as_tensor(res.tokens, dtype=torch.int64, device=dev)
    n_next = SERVE_BATCH * (NEW - 1)
    out = {}
    for d in MESH_DS[1:]:
        mesh = mesh_of(d, dev)
        cu = {key: t.clone() for key, t in base.items()}
        cs = {**base, **{key: [c.contiguous() for c in base[key].chunk(d, dim=3)]
                         for key in ("k", "v")}}
        agree = replay = 0
        outside = rel = 0.0
        for t in range(NEW):
            tok = toks[:, t:t + 1]
            lu, cu = engine.model.decode_step(engine.params, tok, cu)
            ls, cs = engine.model.decode_step(engine.params, tok, cs,
                                              seq_shard_axes=mesh)
            diff = (ls - lu).abs()
            bound = LOGITS_TOL["atol"] + LOGITS_TOL["rtol"] * lu.abs()
            outside = max(outside, (diff > bound).float().mean().item())
            rel = max(rel, (diff.norm() / lu.norm()).item())
            if t + 1 < NEW:
                replay += int((lu[:, 0].argmax(-1) == toks[:, t + 1]).sum())
                agree += int((ls[:, 0].argmax(-1) == toks[:, t + 1]).sum())
        check(replay == n_next, f"the unsharded teacher-forced replay picked "
                                f"{replay} of {n_next} tokens again")
        check(agree >= AGREE_MIN * n_next,
              f"D {d}, teacher-forced: {agree} of {n_next} greedy next tokens "
              f"equal the unsharded step's")
        out[f"D{d}"] = dict(agree=agree / n_next, outside=outside, rel_l2=rel)
        log(f"[stream-mesh] bf16 teacher-forced, B {SERVE_BATCH}, prompt "
            f"{PROMPT}, {NEW} steps at capacity {MESH_CAP}, D {d} against "
            f"unsharded: greedy next tokens equal {agree} of {n_next} "
            f"({agree / n_next:.2%}, >= {AGREE_MIN:.0%} required); worst step "
            f"{outside:.4%} of the logits outside rtol=atol=3e-2, "
            f"|diff|_2/|logits|_2 {rel:.3e}, on {card}")
        del cu, cs
    del base
    torch.cuda.empty_cache()
    return out


def token_share(got: dict, want: dict) -> float:
    """The share of tokens, position by position over every request, equal
    between two streams of the same requests."""
    same = total = 0
    for rid, r in want.items():
        same += int((got[rid].tokens == r.tokens).sum())
        total += r.tokens.size
    return same / max(1, total)


def stream_mesh_phase(dev, card):
    """Phase 15: phase 5b's requests through ``generate_stream(mesh=...)``'s
    scheduler over ``mesh_of(D)`` for D in ``MESH_DS``, internlm2-1.8b at
    full width and depth, bf16, at the capacity ``MESH_CAP`` (which splits
    into 4 shards of whole 128-key blocks): D 1 bit for bit the unsharded
    graphed stream; the op-level check; the dense gate teacher-forced
    (``sharded_teacher_forced``); D 2 and D 4's share of tokens equal to
    the unsharded stream's, free-running, reported; D 4 graph = eager
    bit for bit, 24 x 4 decode launches a step (the wrapper's count of the
    eager stream, and the profiler's trace of the graphed one), each
    request bit for bit itself alone through the same scheduler; then an
    fp32 depth cut at full width (``MESH_CUT`` layers, ``CB_SOLO``
    requests): tokens identical to the unsharded stream's at every D,
    logits within 1e-4.  Returns (the decode kernel's launches on the
    eager D 4 stream, the worst error of its checks, the numbers)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.scheduler import RequestScheduler

    cfg = get_config(ARCH)
    engine = ServingEngine(cfg, seed=SEED)
    layout = engine.cache_layout(MESH_CAP)
    cap = layout.padded_len(MESH_CAP)
    check(cap == MESH_CAP and cap % (MESH_DS[-1] * layout.block_k) == 0,
          f"capacity {cap} (block_k {layout.block_k}) does not split into "
          f"{MESH_DS[-1]} shards")
    reqs = cb_requests(CB_REQUESTS, CB_PROMPTS, CB_BUDGETS, CB_ARRIVALS,
                       cfg.vocab_size, SEED)
    ops_out = sharded_op_check(engine, dev, card)
    forced = sharded_teacher_forced(engine, dev, card)

    def scheduler(params, d, graph=True):
        return RequestScheduler(engine.model, params, CB_SLOTS, cap,
                                layout=layout, device=dev, graph=graph,
                                mesh=None if d is None else mesh_of(d, dev))

    base = scheduler(engine.params, None)
    res_u, wall_u, ms_u = drive(base, reqs)
    del base
    tokens = sum(r.max_new_tokens for r in reqs)
    summary = dict(capacity=cap, unsharded_step_ms_graph=statistics.median(ms_u),
                   unsharded_tokens_per_s=tokens / wall_u, op=ops_out,
                   teacher_forced=forced)
    log(f"[stream-mesh] {cfg.name} at full width, bf16, {CB_REQUESTS} requests "
        f"(phase 5b's) through {CB_SLOTS} slots of capacity {cap}: unsharded "
        f"graph {statistics.median(ms_u):.3f} ms a step, {tokens / wall_u:.1f} "
        f"tokens/s, on {card}")
    launches = 0
    for d in MESH_DS:
        sched = scheduler(engine.params, d)
        check(sched.captures == 1, f"D {d}: the sharded step was not captured")
        res, wall, ms = drive(sched, reqs)
        share = token_share(res, res_u)
        err = max(float(np.abs(res[r].final_logits - res_u[r].final_logits).max())
                  for r in res_u)
        row = dict(step_ms_graph=statistics.median(ms), tokens_per_s_graph=tokens / wall,
                   token_share=share, final_logits_max_diff=err)
        if d == 1:
            same_results(res, res_u, "D 1 vs the unsharded stream")
        if d == MESH_DS[-1]:
            steps = sched.steps_run
            for attempt in range(TRACE_ATTEMPTS):
                res_t, traced, _ = traced_launches(sched, reqs,
                                                   "decode_attention_kernel")
                if traced == cfg.n_layers * d * steps:
                    break
                log(f"[stream-mesh] trace {attempt + 1} held {traced} decode "
                    f"kernels, want {cfg.n_layers} x {d} x {steps}: again")
            check(traced == cfg.n_layers * d * steps,
                  f"{traced} decode kernels in the trace of the graphed D {d} "
                  f"stream, want {cfg.n_layers} x {d} x {steps}")
            same_results(res, res_t, f"D {d} graph vs graph under the profiler")
            eager = scheduler(engine.params, d, graph=False)
            reset_counts()
            res_e, wall_e, ms_e = drive(eager, reqs)
            counts = read_counts()
            launches = counts["decode_attention"]
            want = only(counts, decode_attention=cfg.n_layers * d * eager.steps_run)
            check(counts == want, f"D {d} eager stream launches {counts}, want {want}")
            check(eager.gather_steps == eager.steps_run,
                  f"D {d}: gather_steps {eager.gather_steps} of "
                  f"{eager.steps_run}: the sharded step gathers every step")
            same_results(res, res_e, f"D {d} graph vs eager")
            for r in reqs:
                solo = {x.rid: x for x in sched.run([dataclasses.replace(r, arrival=0)])}
                same_results({r.rid: res[r.rid]}, solo, f"D {d} stream vs solo")
            check(sched.captures == 1, f"D {d}: {sched.captures} captures")
            row.update(step_ms_eager=statistics.median(ms_e),
                       tokens_per_s_eager=tokens / wall_e,
                       traced_launches=traced, eager_launches=launches)
            log(f"[stream-mesh] D {d} graph = eager bit for bit; decode "
                f"launches a step {cfg.n_layers} x {d} = {cfg.n_layers * d} "
                f"(the profiler's trace of the graphed stream {traced}, the "
                f"wrapper's count of the eager one {launches}, over {steps} "
                f"steps); eager {statistics.median(ms_e):.3f} ms a step, "
                f"{tokens / wall_e:.1f} tokens/s; each of the {len(reqs)} "
                f"requests bit for bit itself served alone; captures "
                f"{sched.captures}")
            del eager
        summary[f"D{d}"] = row
        log(f"[stream-mesh] D {d} over [cuda:0] x {d}: graph "
            f"{row['step_ms_graph']:.3f} ms a step ({row['step_ms_graph'] - summary['unsharded_step_ms_graph']:+.3f} "
            f"against unsharded), {row['tokens_per_s_graph']:.1f} tokens/s; "
            f"tokens equal to the unsharded stream's {share:.2%}"
            f"{' (bit for bit)' if d == 1 else ' (free-running, reported)'}; "
            f"final logits max |diff| {err:.3e}, on {card}")
        del sched
        torch.cuda.empty_cache()

    # fp32 at a depth cut of full width: tokens identical, logits 1e-4
    cut = dataclasses.replace(cfg, n_layers=MESH_CUT)
    p32 = transformer.Transformer(cut, dtype=torch.float32, device=dev)
    for name, dst in p32.named_parameters():
        dst.copy_(engine.params.get_parameter(name))
    del engine
    torch.cuda.empty_cache()
    e32 = ServingEngine(cut, params=p32)
    sub = reqs[:CB_SOLO]
    want = {r.rid: r for r in RequestScheduler(
        e32.model, p32, CB_SLOTS, cap, layout=layout, device=dev).run(sub)}
    worst = 0.0
    for d in MESH_DS:
        got = {r.rid: r for r in RequestScheduler(
            e32.model, p32, CB_SLOTS, cap, layout=layout, device=dev,
            mesh=mesh_of(d, dev)).run(sub)}
        for rid, r in want.items():
            check(np.array_equal(got[rid].tokens, r.tokens),
                  f"fp32 cut, D {d}: request {rid}'s tokens differ")
            np.testing.assert_allclose(got[rid].final_logits, r.final_logits,
                                       **E2E_TOL)
            worst = max(worst, float(np.abs(got[rid].final_logits
                                            - r.final_logits).max()))
    log(f"[stream-mesh] fp32 params cut to {MESH_CUT} layers at full width, "
        f"requests {[r.rid for r in sub]}: at D {MESH_DS} tokens identical to "
        f"the unsharded stream's, final logits max |diff| {worst:.3e} "
        f"(tolerance 1e-4)")
    summary["fp32_cut_err"] = worst
    del e32, p32
    torch.cuda.empty_cache()
    err = max(max(ops_out["errs"].values()), max(ops_out["shard_errs"].values()))
    return launches, err, summary


# ---------------------------------------------------------------------------
# 6. the flash-attention prefill kernel
# ---------------------------------------------------------------------------


def attention_bound(B, H, KV, Sq, Sk, D, dtype, causal, peaks):
    """Least time for one prefill attention call: q, k, v and o each moved
    once over HBM, against 2·D FLOPs of q·kᵀ and 2·D of p·v for every
    (query, key) pair the mask keeps, on the least exact route for each.
    bf16 inputs: q·kᵀ is exact on bf16 tensor cores with fp32
    accumulation; p stays fp32, and an fp32 p against a bf16 v is exact as
    three bf16 tensor-core products (p split into hi, mid and lo), so p·v
    costs three times q·kᵀ's work, all at the bf16 peak.  fp32 inputs:
    both products at the fp32 peak.  Returns the bound, what bounds it,
    the bytes and the attention's own FLOPs (one p·v)."""
    e = torch.tensor([], dtype=dtype).element_size()
    bytes_ = (2 * B * H * Sq * D + 2 * B * KV * Sk * D) * e
    pairs = (sum(min(i + 1, Sk) for i in range(Sq)) if causal else Sq * Sk)
    half = 2.0 * B * H * D * pairs
    flops = 2 * half
    t_bytes = bytes_ / peaks[0] * 1e3
    if dtype == torch.bfloat16:
        t_ops = (half + 3 * half) / peaks[2] * 1e3
    else:
        t_ops = flops / peaks[1] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            bytes_, flops)


def flash_phase(dev, peaks, card):
    """The kernel against its plain version, its path (``mha`` at the
    prefill and long shapes), then its times.  Returns (timing, launches,
    max error)."""
    from repro_torch.kernels.flash_attention import ops, ref

    gen = torch.Generator(device=dev).manual_seed(SEED)

    def operands(B, H, KV, Sq, Sk, D, dtype):
        return [torch.randn(shape, generator=gen, device=dev, dtype=dtype)
                for shape in ((B, H, Sq, D), (B, KV, Sk, D), (B, KV, Sk, D))]

    def held(name, q, k, v, causal=True, out=None, control=False):
        """``control``: also check that the bf16 plain version, which rounds
        p to bf16, falls under ``EXACT_SHARE``, so that the share check can
        tell an fp32 p·v from a rounded one at this shape."""
        got = ops.mha(q, k, v, causal=causal) if out is None else out
        want = ref.flash_attention_ref(q, k, v, causal=causal)
        torch.cuda.synchronize()
        tol = DECODE_TOL[q.dtype]
        err = (got.float() - want.float()).abs().max().item()
        torch.testing.assert_close(got.float(), want.float(), **tol,
                                   msg=lambda m: f"flash {name}: {m}")
        wide = ""
        if q.dtype == torch.bfloat16:
            plain = want
            want = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                           causal=causal)
            werr = (got.float() - want).abs().max().item()
            torch.testing.assert_close(got.float(), want, **ULP_TOL,
                                       msg=lambda m: f"flash {name} vs fp32: {m}")
            rounded = want.to(torch.bfloat16)
            share = (got == rounded).float().mean().item()
            plain_share = (plain == rounded).float().mean().item()
            check(share >= EXACT_SHARE,
                  f"flash {name}: {share:.4%} of the elements equal the "
                  f"fp32-widened plain version rounded to bf16, under "
                  f"{EXACT_SHARE:.0%}")
            if control:
                check(plain_share < EXACT_SHARE,
                      f"flash {name}: the bf16 plain version (p rounded to "
                      f"bf16) has {plain_share:.4%} of its elements equal too")
            wide = (f"; vs the plain version on fp32-widened inputs {werr:.3e} "
                    f"(rtol {ULP_TOL['rtol']}, atol {ULP_TOL['atol']}), "
                    f"{share:.4%} of the elements equal to it rounded to bf16 "
                    f"(at least {EXACT_SHARE:.0%}; the bf16 plain version, p "
                    f"rounded to bf16: {plain_share:.4%})")
            del plain, rounded
        log(f"  flash {name}: shape {tuple(got.shape)} max_abs_err {err:.3e} "
            f"(tolerance rtol=atol={tol['atol']}){wide}")
        del want
        return err

    errs = []
    for dtype in (torch.float32, torch.bfloat16):
        for B, H, KV, S, D in FLASH_TEST_SHAPES:
            errs.append(held(f"test shape B{B} H{H} KV{KV} S{S} D{D} {dtype}",
                             *operands(B, H, KV, S, S, D, dtype)))
        errs.append(held(f"non-causal Sq 128 Sk 256 {dtype}",
                         *operands(1, 2, 2, 128, 256, 64, dtype), causal=False))
    q, k, v = operands(1, 2, 2, 512, 512, 64, torch.float32)
    a = ops.mha(q, k, v, block_q=128, block_k=128)
    b = ops.mha(q, k, v, block_q=256, block_k=64)
    check(torch.equal(a, b), "flash: block_q/block_k changed the result")
    errs.append(held("blocks 256/64 (equal to 128/128, bitwise)", q, k, v,
                     out=b))

    # the path: the entry point at the prefill shapes and the long shape
    B, H, KV, S, D = FLASH_SHAPE
    main = {dt: operands(B, H, KV, S, S, D, dt)
            for dt in (torch.bfloat16, torch.float32)}
    LB, LH, LKV, LS, LD = FLASH_LONG
    long = operands(LB, LH, LKV, LS, LS, LD, torch.bfloat16)
    reset_counts()
    outs = {"bf16": ops.mha(*main[torch.bfloat16]),
            "fp32": ops.mha(*main[torch.float32]), "long": ops.mha(*long)}
    torch.cuda.synchronize()
    counts = read_counts()
    check(counts == only(counts, flash_attention=3), f"flash path launches {counts}")
    for tag, ins in (("bf16", main[torch.bfloat16]), ("fp32", main[torch.float32]),
                     ("long", long)):
        errs.append(held(f"path {tag} {tuple(ins[0].shape)}", *ins,
                         out=outs[tag], control=tag != "fp32"))
    del outs

    def times(q, k, v, tag, reps, burst=False):
        Bq, Hq, Sq, Dq = q.shape
        kernel = lambda: ops.mha(q, k, v)  # noqa: E731
        ms = time_ms(kernel, reps=reps)
        plain_ms = time_ms(lambda: ref.flash_attention_ref(q, k, v), reps=reps)
        lib_ms = lib_err = call = None
        try:
            call = sdpa_call(q, k, v, causal=True)
            lib_err = (call().float() - ops.mha(q, k, v).float()).abs().max().item()
            lib_ms = time_ms(call, reps=reps)
        except (RuntimeError, NotImplementedError, ValueError) as e:
            log(f"  {tag}: library call refused: {type(e).__name__}: {e}")
        b_ms, b_by, nbytes, flops = attention_bound(
            Bq, Hq, k.shape[1], Sq, k.shape[2], Dq, q.dtype, True, peaks)
        route = ("q·kᵀ and p·v (three exact bf16 products) at the bf16 peak, "
                 f"{2 * flops / 1e9:.3f} GFLOP of tensor-core work"
                 if q.dtype == torch.bfloat16 else "both products at the fp32 peak")
        log(f"[time] flash_attention {tag}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, library {fmt_ms(lib_ms)} ms (max |library"
            f" - kernel| {lib_err}), bound {b_ms:.4f} ms by {b_by} "
            f"({nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP, {route}; "
            f"{flops / ms / 1e9:.2f} TFLOP/s achieved) on {card}")
        extra = back_to_back("flash_attention", tag, kernel, call) if burst else {}
        return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                    bound_by=b_by, **extra)

    timing = times(*main[torch.bfloat16],
                   f"prefill shape B{B} H{H} KV{KV} S{S} D{D} causal bf16", 20,
                   burst=True)
    timing["fp32"] = times(*main[torch.float32],
                           f"prefill shape B{B} H{H} KV{KV} S{S} D{D} causal fp32",
                           20, burst=True)
    del main
    timing["long"] = dict(shape=list(FLASH_LONG), **times(
        *long, f"long B{LB} H{LH} KV{LKV} S{LS} D{LD} causal bf16", 3))
    del long, q, k, v, a, b
    torch.cuda.empty_cache()
    return timing, counts["flash_attention"], max(errs)


# ---------------------------------------------------------------------------
# 7. mamba2-370m: the SSD scan kernel and the serving path
# ---------------------------------------------------------------------------


def ssd_bound(B, H, G, L, P, N, chunk, dtype, peaks):
    """Least time for one SSD scan: x, dt, A, B, C, y and the final state
    each moved once over HBM, against the products the kernels run: C·B over
    the causal half once per group and, per head, M·(x dt) over the causal
    half, C·S_prevᵀ and the chunk state.  For bf16 inputs every product runs
    on tensor cores at the bf16 peak, C·B once (its products of bf16 are
    exact) and the other three three times (their fp32 operand split into
    three bf16 pieces); for fp32 inputs all at the fp32 peak."""
    e = torch.tensor([], dtype=dtype).element_size()
    bytes_ = ((2 * B * H * L * P + 2 * B * G * L * N) * e + B * H * L * 4
              + H * 4 + B * H * P * N * 4)
    nc, tri = L // chunk, chunk * (chunk + 1) // 2
    cb = 2.0 * B * nc * G * tri * N
    rest = 2.0 * B * nc * H * (tri * P + 2 * chunk * P * N)
    if dtype != torch.bfloat16:
        flops, t_ops = cb + rest, (cb + rest) / peaks[1] * 1e3
    else:
        flops, t_ops = cb + 3 * rest, (cb + 3 * rest) / peaks[2] * 1e3
    t_bytes = bytes_ / peaks[0] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            bytes_, flops)


def ssd_phase_work(B, H, G, L, P, N, chunk) -> dict:
    """The FLOPs each kernel of one ``ops.ssd`` call needs (as ``ssd_bound``
    counts them): C·B over the causal half per group; each chunk's state;
    the passing, a product and a sum a state element and chunk; y's two
    products, M·(x dt) over the causal half and C·S_prevᵀ."""
    from repro_torch.kernels.ssd_scan.ops import PHASES

    nc, tri = L // chunk, chunk * (chunk + 1) // 2
    return dict(zip(PHASES, (2.0 * B * G * nc * tri * N,
                             2.0 * B * H * nc * chunk * P * N,
                             2.0 * B * H * nc * P * N,
                             2.0 * B * H * nc * (tri * P + chunk * P * N))))


def ssd_launches(call, n: int = 10) -> dict:
    """Each kernel of ``ops.ssd`` as ``torch.profiler``'s trace of ``n``
    calls records it: device ms a call (``device_ms``) and the blocks of its
    grid (``blocks``); None where the trace has no such kernel or its grid
    differs between calls."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.ssd_scan.ops import PHASES

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            call()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        trace = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(trace))
        events = json.loads(trace.read_text())["traceEvents"]
    us = dict.fromkeys(PHASES, 0.0)
    grids = {name: set() for name in PHASES}
    for e in events:
        if e.get("cat") != "kernel":
            continue
        for name in PHASES:
            if name in e.get("name", ""):
                us[name] += e.get("dur", 0.0)
                grid = e.get("args", {}).get("grid")
                grids[name].add(math.prod(grid) if grid else None)
    return {name: dict(device_ms=us[name] / 1e3 / n if us[name] > 0 else None,
                       blocks=(next(iter(grids[name]))
                               if len(grids[name]) == 1 else None))
            for name in PHASES}


def ssd_phase(dev, peaks, card, engine, prompts):
    """The kernel against its plain version, its path (``ssd`` on layer 0's
    real inputs for the served prompts and at the long shape), then its
    times.  Returns (timing, launches, max error)."""
    from repro_torch.kernels.ssd_scan import ops, ref
    from repro_torch.models import layers, mamba2

    F = torch.nn.functional
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def recipe(B, H, G, L, P, N, dtype, dt_shift=0.0, a_one=False):
        """The reference's input recipe; the model's init gives dt =
        softplus(normal - 2) and A = -1."""
        def rn(*shape):
            return torch.randn(shape, generator=gen, device=dev)
        A = (-torch.ones(H, device=dev) if a_one
             else -torch.exp(rn(H) * 0.3))
        return (rn(B, H, L, P).to(dtype), F.softplus(rn(B, H, L) + dt_shift),
                A, rn(B, G, L, N).to(dtype), rn(B, G, L, N).to(dtype))

    def held(name, ins, chunk, out=None):
        y, s = ops.ssd(*ins, chunk=chunk) if out is None else out
        wy, ws = ref.ssd_scan_ref(*ins, chunk=chunk)
        torch.cuda.synchronize()
        tol = DECODE_TOL[ins[0].dtype]
        ey = (y.float() - wy).abs().max().item()
        es = (s - ws).abs().max().item()
        torch.testing.assert_close(y.float(), wy, **tol,
                                   msg=lambda m: f"ssd {name} y: {m}")
        torch.testing.assert_close(s, ws, rtol=5 * tol["rtol"],
                                   atol=5 * tol["atol"],
                                   msg=lambda m: f"ssd {name} state: {m}")
        wide = ""
        if ins[0].dtype == torch.bfloat16:
            wy = ref.ssd_scan_ref(*(t.float() for t in ins), chunk=chunk)[0]
            wey = (y.float() - wy).abs().max().item()
            torch.testing.assert_close(y.float(), wy, **ULP_TOL,
                                       msg=lambda m: f"ssd {name} y vs fp32: {m}")
            # the plain version widens to fp32, so ws is its state on
            # fp32-widened inputs
            torch.testing.assert_close(s, ws, **SSD_STATE_TOL,
                                       msg=lambda m: f"ssd {name} state vs fp32: {m}")
            share = exact_share(y, wy)
            check(share >= EXACT_SHARE,
                  f"ssd {name}: {share:.4%} of y equal to the plain version "
                  f"on fp32-widened inputs rounded to bf16, under "
                  f"{EXACT_SHARE:.0%}")
            wide = (f", y vs the plain version on fp32-widened inputs {wey:.3e} "
                    f"(rtol {ULP_TOL['rtol']}, atol {ULP_TOL['atol']}), "
                    f"{share:.4%} of y equal to it rounded (>= "
                    f"{EXACT_SHARE:.0%}), state at {SSD_STATE_TOL['atol']}")
        log(f"  ssd {name}: max_abs_err y {ey:.3e} (|y| <= "
            f"{wy.abs().max().item():.1f}, tolerance rtol=atol={tol['atol']}), "
            f"state {es:.3e} (5x){wide}")
        return max(ey, es)

    one_piece_lib = variant("one_piece")

    def one_piece(name, ins, chunk):
        """The control: the kernels built with split3 cut to one piece must
        fail both bf16 checks of ``held``, the state at ``SSD_STATE_TOL``
        and y's exact share."""
        x, dt, A, Bm, Cm = ins
        y, s = ops.launch(one_piece_lib, x, dt.float().contiguous(),
                          A.float().contiguous(), Bm, Cm, chunk)
        wy, ws = ref.ssd_scan_ref(*ins, chunk=chunk)
        torch.cuda.synchronize()
        es = (s - ws).abs().max().item()
        state_held = torch.allclose(s, ws, **SSD_STATE_TOL)
        share = exact_share(y, wy)
        log(f"[check] ssd control, split3 cut to one piece, {name}: state "
            f"{es:.3e} ({'inside' if state_held else 'outside'} "
            f"rtol=atol={SSD_STATE_TOL['atol']}), {share:.4%} of y equal to "
            f"the plain version rounded (limit {EXACT_SHARE:.0%})")
        check(not state_held and share < EXACT_SHARE,
              f"ssd {name}: the bf16 checks pass a one-piece split")

    errs = []
    for dtype in (torch.float32, torch.bfloat16):
        for B, H, G, L, P, N, chunk in SSD_TEST_SHAPES:
            errs.append(held(f"test shape B{B} H{H} G{G} L{L} P{P} N{N} "
                             f"chunk {chunk} {dtype}",
                             recipe(B, H, G, L, P, N, dtype), chunk))
    B, H, G, L, P, N, chunk = SSD_TEST_SHAPES[-1]
    one_piece(f"test shape B{B} H{H} G{G} L{L} P{P} N{N} chunk {chunk}",
              recipe(B, H, G, L, P, N, torch.bfloat16), chunk)
    # the final state against a sequential per-token recurrence
    x, dt, A, Bm, Cm = ins = recipe(1, 2, 1, 64, 16, 8, torch.float32)
    _, s = ops.ssd(*ins, chunk=32)
    want = torch.zeros_like(s)
    for t in range(64):
        a = torch.exp(dt[:, :, t] * A[None])
        want = want * a[..., None, None] + torch.einsum(
            "bh,bn,bhp->bhpn", dt[:, :, t], Bm[:, 0, t], x[:, :, t])
    torch.testing.assert_close(s, want, rtol=1e-4, atol=1e-4)
    log(f"  ssd state vs the sequential recurrence (L 64, chunk 32): max_abs_err "
        f"{(s - want).abs().max().item():.3e} (tolerance 1e-4)")

    # layer 0's real SSD inputs for the served prompts, in the kernel layout
    cfg = engine.cfg
    tokens = torch.as_tensor(prompts, dtype=torch.int64, device=dev)
    h0 = layers.embed_tokens(engine.params.embed, tokens)
    xs, dt_, A0, Bm0, Cm0, _, _ = mamba2.ssm_inputs(engine.params.blocks[0], h0,
                                                    cfg)
    model = (xs.transpose(1, 2).contiguous(), dt_.transpose(1, 2).contiguous(),
             A0, Bm0.transpose(1, 2).contiguous(), Cm0.transpose(1, 2).contiguous())
    del h0, xs, dt_, Bm0, Cm0
    B, H, L, P = model[0].shape
    G, N, chunk = model[3].shape[1], model[3].shape[3], cfg.ssm_chunk
    LB, LH, LG, LL, LP, LN, Lc = SSD_LONG
    long = recipe(LB, LH, LG, LL, LP, LN, torch.bfloat16, dt_shift=-2.0,
                  a_one=True)
    reset_counts()
    outs = {"model": ops.ssd(*model, chunk=chunk), "long": ops.ssd(*long, chunk=Lc)}
    torch.cuda.synchronize()
    counts = read_counts()
    check(counts == only(counts, ssd_scan=2), f"ssd path launches {counts}")
    errs.append(held(f"path: layer 0 of {cfg.name} for the served prompts, B{B} "
                     f"H{H} G{G} L{L} P{P} N{N} chunk {chunk} "
                     f"{model[0].dtype}", model, chunk, out=outs["model"]))
    errs.append(held(f"path: long B{LB} H{LH} L{LL} chunk {Lc} bf16", long, Lc,
                     out=outs["long"]))
    del outs
    one_piece(f"layer 0 of {cfg.name}", model, chunk)
    one_piece(f"long B{LB} H{LH} L{LL}", long, Lc)

    def times(ins, chunk, tag, reps):
        Bx, Hx, Lx, Px = ins[0].shape
        Gx, Nx = ins[3].shape[1], ins[3].shape[3]
        shape = (Bx, Hx, Gx, Lx, Px, Nx, chunk)
        call = lambda: ops.ssd(*ins, chunk=chunk)  # noqa: E731
        ms = time_ms(call, reps=reps)
        plain_ms = time_ms(lambda: ref.ssd_scan_ref(*ins, chunk=chunk), reps=reps)
        b_ms, b_by, nbytes, flops = ssd_bound(*shape, ins[0].dtype, peaks)
        graph = graph_ms(call, n=10, reps=3)
        log(f"[time] ssd_scan {tag}: kernel {ms:.4f} ms a single call, "
            f"{graph:.4f} from a CUDA graph; plain {plain_ms:.4f} "
            f"ms, library none (PyTorch has no call that computes the SSD "
            f"scan), bound {b_ms:.4f} ms by {b_by} ({nbytes / 1e6:.1f} MB, "
            f"{flops / 1e9:.3f} GFLOP of tensor-core products, the fp32 "
            f"operands split in three; {flops / graph / 1e9:.1f} TFLOP/s "
            f"from the graph, {graph / b_ms:.2f}x the bound) on {card}")
        work = ssd_phase_work(*shape)
        launches = ssd_launches(call)
        parts = []
        for name in ops.PHASES:
            t = launches[name]["device_ms"]
            rate = "not measured" if t is None else f"{work[name] / t / 1e9:.2f}"
            parts.append(f"{name} {fmt_ms(t)} ms, {launches[name]['blocks']} "
                         f"blocks, {work[name] / 1e9:.3f} GFLOP, {rate} TFLOP/s")
        times_ = [v["device_ms"] for v in launches.values()]
        total = sum(times_) if None not in times_ else None
        log(f"[time] ssd_scan {tag} phases (the profiler trace's device time "
            f"a call and grid; GFLOP of the scan's own products, before any "
            f"split): {'; '.join(parts)}; sum {fmt_ms(total)} ms on {card}")
        return dict(ms=ms, graph_ms=graph, plain_ms=plain_ms, library_ms=None,
                    bound_ms=b_ms, bound_by=b_by), launches

    timing, _ = times(model, chunk, f"model shape B{B} H{H} G{G} L{L} P{P} "
                      f"N{N} chunk {chunk} bf16", 20)
    row, launches = times(long, Lc, f"long B{LB} H{LH} L{LL} chunk {Lc} bf16", 3)
    timing["long"] = dict(shape=list(SSD_LONG), **row)
    blocks = {name: v["blocks"] for name, v in launches.items()}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    log(f"[config] ssd_scan launches at the long shape B{LB} H{LH} L{LL}, "
        f"blocks as the profiler's trace records them: {blocks} on {sms} SMs")
    check(None not in blocks.values() and min(blocks.values()) >= 132,
          f"a phase at the long shape has fewer than 132 blocks: {blocks}")
    del model, long
    torch.cuda.empty_cache()
    return timing, counts["ssd_scan"], max(errs)


def mamba2_phase(dev, peaks, card):
    """mamba2-370m at full width: the SSD kernel's phase on the served
    prompts, then ``ServingEngine.generate``, its profile, and the fp32
    engine on the card against the CPU.  Returns the SSD kernel's (timing,
    launches, max error)."""
    from repro_torch.configs import get_config
    from repro_torch.models import mamba2
    from repro_torch.serving.engine import ServingEngine

    cfg = get_config(SSM_ARCH)
    t = time.time()
    engine = ServingEngine(cfg, seed=SEED)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in engine.params.parameters())
    p_bytes = sum(p.numel() * p.element_size() for p in engine.params.parameters())
    state_bytes = (cfg.n_layers * SERVE_BATCH * cfg.ssm_heads * cfg.ssm_head_dim
                   * cfg.ssm_state * 4)
    log(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.ssm_heads} SSM heads of {cfg.ssm_head_dim}, state "
        f"{cfg.ssm_state}, {cfg.ssm_groups} group, chunk {cfg.ssm_chunk}, "
        f"vocab {cfg.vocab_size} padded to {cfg.padded_vocab()}; "
        f"{n_params / 1e6:.1f} M params ({p_bytes / 1e9:.3f} GB, "
        f"{engine.params.embed.dtype}, A_log/dt_bias/D fp32) drawn on the card "
        f"from seed {SEED} in {time.time() - t:.1f} s; SSM state "
        f"{state_bytes / 1e9:.3f} GB fp32 at batch {SERVE_BATCH}")
    rng = np.random.default_rng(1)
    prompts = rng.integers(0, cfg.vocab_size,
                           size=(SERVE_BATCH, PROMPT)).astype(np.int32)

    ssd = ssd_phase(dev, peaks, card, engine, prompts)

    engine.generate(prompts[:, :16], max_new_tokens=2)  # warm-up
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = engine.generate(prompts, max_new_tokens=NEW)
    t_first = time.perf_counter() - t
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    check(launches == only(launches), f"mamba2 serving launches {launches}")
    V = cfg.padded_vocab()
    check(res.tokens.shape == (SERVE_BATCH, NEW)
          and bool(((res.tokens >= 0) & (res.tokens < V)).all()),
          f"tokens {res.tokens.shape} out of range")
    check(res.prefill_logits.shape == (SERVE_BATCH, V)
          and bool(np.isfinite(res.prefill_logits).all()),
          "last step's logits not finite")
    log(f"[serve] {cfg.name} generate(B {SERVE_BATCH}, prompt {PROMPT}, {NEW} "
        f"new): {t_first:.3f} s host wall (first timed run); launches of the "
        f"hand-written kernels 0 (the path runs the plain ssd_chunked and "
        f"ssd_decode, as the reference's model does); peak device memory "
        f"{peak / 1e9:.2f} GB; first tokens {res.tokens[0, :8].tolist()}")

    def wall(n_new, reps=3):
        ts = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine.generate(prompts, max_new_tokens=n_new)
            ts.append(time.perf_counter() - t0)
        return statistics.median(ts)

    t_prefill, t_gen = wall(0), wall(NEW)
    step = (t_gen - t_prefill) / NEW
    log(f"[serve] {cfg.name} prefill {t_prefill * 1e3:.2f} ms (median of 3 "
        f"generate(..., 0)); generate {t_gen * 1e3:.2f} ms (median of 3); decode "
        f"{step * 1e3:.3f} ms/step, {SERVE_BATCH / step:.1f} tokens/s; end to "
        f"end {SERVE_BATCH * NEW / t_gen:.1f} tokens/s, on {card}")
    profile_decode(engine, prompts, step * 1e3, kernel=None)
    cb_ssm(engine, dev, card)

    # fp32 copies of the same params: the engine on the card and on the CPU
    p32 = mamba2.Mamba2(cfg, dtype=torch.float32, device=dev)
    for dst, src in zip(p32.parameters(), engine.params.parameters()):
        dst.copy_(src)
    del engine
    torch.cuda.empty_cache()
    cpu = mamba2.Mamba2(cfg, dtype=torch.float32, device="cpu")
    for dst, src in zip(cpu.parameters(), p32.parameters()):
        dst.copy_(src.cpu())
    short = prompts[:SSM_CPU_BATCH, :SSM_CPU_PROMPT]
    t = time.time()
    a = ServingEngine(cfg, params=p32).generate(short, max_new_tokens=SSM_CPU_NEW)
    t_card = time.time() - t
    t = time.time()
    b = ServingEngine(cfg, params=cpu, device="cpu").generate(
        short, max_new_tokens=SSM_CPU_NEW)
    t_cpu = time.time() - t
    check(np.array_equal(a.tokens, b.tokens),
          f"fp32 tokens differ, card {a.tokens} vs cpu {b.tokens}")
    err32 = float(np.abs(a.prefill_logits - b.prefill_logits).max())
    np.testing.assert_allclose(a.prefill_logits, b.prefill_logits, **SSM_CPU_TOL)
    log(f"[serve] {cfg.name} fp32 params, B {SSM_CPU_BATCH}, prompt "
        f"{SSM_CPU_PROMPT}, {SSM_CPU_NEW} new tokens: card and CPU tokens "
        f"identical {a.tokens.tolist()}; last-step max |logits diff| "
        f"{err32:.3e} (tolerance 1e-4; logits std "
        f"{float(b.prefill_logits.std()):.3f}); card {t_card:.1f} s, CPU "
        f"{t_cpu:.1f} s host wall")
    del p32, cpu
    torch.cuda.empty_cache()
    return ssd


# ---------------------------------------------------------------------------
# 8. the LM pipeline over the serverless fabric
# ---------------------------------------------------------------------------


def timed_stages(executors, spans: list) -> None:
    """Wrap each stage's compute so that every call appends (start event,
    end event) around it to ``spans``: the stage compute's time on the
    card, which the pipeline's next step (the activation's copy to the
    host, or the token's) waits for."""
    for ex in executors:
        for attr in ("prefill_fn", "decode_fn"):
            def timed(*args, _fn=getattr(ex, attr)):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                out = _fn(*args)
                e1.record()
                spans.append((e0, e1))
                return out
            setattr(ex, attr, timed)


def pipeline_run(cfg, prompts, params, executors, spans, new, **kw):
    """One ``run_lm_pipeline`` with the launch counts from 0.  Returns (the
    result, the counts, host wall s, stage compute s)."""
    from repro_torch.faas.lm_pipeline import run_lm_pipeline

    spans.clear()
    reset_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = run_lm_pipeline(cfg, prompts, params, max_new_tokens=new,
                          executors=executors, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = read_counts()
    stage = sum(e0.elapsed_time(e1) for e0, e1 in spans) / 1e3
    return res, counts, wall, stage


def pipeline_line(tag, res, wall, stage, card) -> str:
    m, st = res.metrics, res.stats
    return (f"[pipeline] {tag}: {wall:.3f} s host wall = {stage:.3f} s stage "
            f"compute (between CUDA events) + {wall - stage:.3f} s host "
            f"(packing, zlib, drains, the simulator); makespan "
            f"{res.makespan:.4f} s (phased {m['phased_makespan_s']:.4f}, "
            f"overlap {m['overlap_makespan_s']:.4f}); cost "
            f"{res.cost.total:.6e} USD; hops {m['hops']:.0f}, messages "
            f"{m.get('messages', 0):.0f}, publish units {st.publish_units}, "
            f"SQS calls {st.sqs_api_calls}, S3 puts {st.s3_puts} gets "
            f"{st.s3_gets} lists {st.s3_lists}; raw bytes "
            f"{res.raw_exchange_bytes}, wire bytes {res.wire_exchange_bytes}; "
            f"flops {m['flops_total']:.6e}, memory {st.memory_mb} MB, on {card}")


def same_generation(res, want, what: str) -> None:
    check(np.array_equal(res.tokens, want.tokens),
          f"{what}: tokens {res.tokens[0, :8]} vs {want.tokens[0, :8]}")
    check(np.array_equal(res.logits, want.prefill_logits),
          f"{what}: logits not bit for bit (max |diff| "
          f"{np.abs(res.logits - want.prefill_logits).max():.3e})")


def pipeline_phase(dev, card):
    """``run_lm_pipeline`` at internlm2-1.8b's full width (bf16 params from
    seed 0, ``torch-splitk``), P = 4 stages, on the queue and the object
    channel, each with the overlap and the phased clock: tokens and logits
    bit for bit the device engine's, the decode kernel launched once a
    layer a step, the KV resident in the stages.  Returns (the decode
    kernel's launches in one run, the numbers)."""
    from repro_torch.configs import get_config
    from repro_torch.faas.lm_pipeline import build_stage_executors
    from repro_torch.serving.engine import ServingEngine

    cfg = get_config(ARCH)
    B, S, new = PIPE_BATCH, PIPE_PROMPT, PIPE_NEW
    engine = ServingEngine(cfg, seed=SEED)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    want = engine.generate(prompts, max_new_tokens=new)
    executors = build_stage_executors(cfg, engine.params, PIPE_P,
                                      attn_backend=engine.attn_backend)
    check([ex.spec.n_layers for ex in executors] == [cfg.n_layers // PIPE_P] * PIPE_P,
          f"stages {[ex.spec for ex in executors]}")
    spans: list = []
    timed_stages(executors, spans)
    log(f"[pipeline] {cfg.name} at full width, {engine.attn_backend.name}, P "
        f"{PIPE_P} stages of {[ex.spec.n_layers for ex in executors]} layers "
        f"(weights {[round(ex.weight_bytes / 1e9, 3) for ex in executors]} GB, "
        f"slices of the engine's tensors); batch {B}, prompts of {S}, {new} "
        f"new tokens from np.random.default_rng(0)")
    summary = {}
    for ch in ("queue", "object"):
        runs = {}
        for overlap in (True, False):
            res, counts, wall, stage = pipeline_run(
                cfg, prompts, engine.params, executors, spans, new, P=PIPE_P,
                channel=ch, overlap=overlap)
            want_counts = only(counts, decode_attention=cfg.n_layers * new)
            check(counts == want_counts, f"{ch}: launches {counts}, want "
                                         f"{want_counts}")
            same_generation(res, want, f"pipeline {ch} vs the device engine")
            for ex in executors:
                check(ex.cache["k"].shape[0] == ex.spec.n_layers,
                      f"stage {ex.spec.index} holds {ex.cache['k'].shape[0]} "
                      f"layers of KV")
            clock = "overlap" if overlap else "phased"
            log(pipeline_line(f"{ch}, {clock} clock", res, wall, stage, card))
            runs[overlap] = res
            summary[f"{ch}_{clock}"] = dict(
                wall_s=wall, stage_compute_s=stage, host_s=wall - stage,
                makespan_s=res.makespan, cost_usd=res.cost.total,
                messages=res.metrics.get("messages", 0.0),
                raw_bytes=res.raw_exchange_bytes)
        a, b = runs[True], runs[False]
        check(np.array_equal(a.tokens, b.tokens)
              and np.array_equal(a.logits, b.logits), f"{ch}: overlap != phased")
        for f in ("P", "memory_mb", "publish_units", "bytes_sns_to_sqs",
                  "sqs_api_calls", "s3_puts", "s3_gets", "s3_lists"):
            check(getattr(a.stats, f) == getattr(b.stats, f), f"{ch}: {f}")
        check(a.raw_exchange_bytes == b.raw_exchange_bytes
              and a.wire_exchange_bytes == b.wire_exchange_bytes
              and a.cost.communication == b.cost.communication,
              f"{ch}: billed bytes differ between the clocks")
        check(a.makespan <= b.makespan + 1e-12, f"{ch}: overlap later")
    log(f"[pipeline] every run: tokens and logits bit for bit the device "
        f"engine's; {cfg.n_layers} x {new} = {cfg.n_layers * new} decode "
        f"kernels a run; every billed count equal between the overlap and "
        f"phased clocks; each stage's cache holds its own "
        f"{cfg.n_layers // PIPE_P} layers")
    del executors, engine
    torch.cuda.empty_cache()
    return cfg.n_layers * new, summary


# ---------------------------------------------------------------------------
# 9. deepseek-moe-16b at full width
# ---------------------------------------------------------------------------


def moe_kernel(dev, peaks, card, cfg, S):
    """The decode kernel at deepseek's decode shape (fp32 cache, G 1, D
    128) with a bf16 q that the backend widens: against its plain version
    on the widened q at 1e-5, the backend's bf16 output that of the fp32
    kernel rounded once; then timed.  Returns (timing, max error)."""
    from repro_torch.core.backends import TorchSplitKAttention
    from repro_torch.kernels.decode_attention import ops, ref

    B, H, KV, D = SERVE_BATCH, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    q = torch.randn((B, H, D), generator=gen, device=dev).to(torch.bfloat16)
    k, v = [torch.randn((B, KV, S, D), generator=gen, device=dev)
            for _ in range(2)]
    qf = q.float()
    be = TorchSplitKAttention(device=dev)
    worst = 0.0
    for L in MOE_LENS:
        lt = torch.tensor([L], dtype=torch.int32, device=dev)
        out, lse = ops.decode_mha(qf, k, v, lt)
        want, want_lse = ref.decode_attention_ref(qf, k, v, lt)
        torch.testing.assert_close(out, want, **TOL)
        torch.testing.assert_close(lse, want_lse, **TOL)
        got = be.decode(q[:, None], k, v, lt)[:, 0]
        check(got.dtype == torch.bfloat16
              and torch.equal(got, out.to(torch.bfloat16)),
              f"cache_len {L}: the widened bf16 call is not the fp32 kernel "
              f"rounded once")
        err = (out - want).abs().max().item()
        worst = max(worst, err)
        log(f"  moe decode B{B} H{H} KV{KV} S{S} D{D}, bf16 q widened over "
            f"the fp32 cache, cache_len {L}: max_abs_err out {err:.3e}, lse "
            f"{(lse - want_lse).abs().max().item():.3e} (tolerance 1e-5); the "
            f"bf16 output equals the fp32 kernel's rounded, bit for bit")
    L = PROMPT + NEW
    lt = torch.tensor([L], dtype=torch.int32, device=dev)
    kernel = lambda: ops.decode_mha(qf, k, v, lt)  # noqa: E731
    library = sdpa_call(qf, k, v, L)
    lib_err = (library() - kernel()[0]).abs().max().item()
    ms = time_ms(kernel, reps=20)
    plain_ms = time_ms(lambda: ref.decode_attention_ref(qf, k, v, lt), reps=20)
    lib_ms = time_ms(library, reps=20)
    extra = back_to_back("decode_attention", f"moe shape fp32 cache_len {L}",
                         kernel, library)
    b_ms, b_by, nbytes, flops = decode_bound(B, H, KV, L, D, torch.float32, peaks)
    log(f"[time] decode_attention moe shape B{B} H{H} KV{KV} S{S} D{D} fp32 "
        f"cache_len {L}: kernel {ms:.4f} ms, {extra['graph_ms']:.4f} from a "
        f"CUDA graph, plain {plain_ms:.4f} ms, library (SDPA) {lib_ms:.4f} ms, "
        f"{extra['library_graph_ms']:.4f} from a CUDA graph (max |library - "
        f"kernel| {lib_err:.3e}), bound {b_ms:.4f} ms by {b_by} "
        f"({nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP), on {card}")
    return dict(shape=[B, H, KV, S, D], dtype="float32", cache_len=L, ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                bound_by=b_by, **extra), worst


def pinned_route(logits, idx, normalize=True):
    """``moe.route_topk``'s gate weights at the given expert ids ``idx``:
    a softmax over the selected logits, or (``normalize`` False) the
    selected entries of a softmax over all of them."""
    if not normalize:
        return torch.gather(torch.softmax(logits.float(), dim=-1), -1, idx), idx
    return torch.softmax(torch.gather(logits, -1, idx).float(), dim=-1), idx


def moe_teacher_forced(engine, prompts, res, dev, card) -> dict:
    """Teacher-forced on ``res``'s tokens, bf16, the kernel's engine against
    the same params through the kernel's plain version, twice.  Free: each
    run routes on its own logits; reported are the share of logits outside
    3e-2, of equal greedy next tokens and of (token, layer) pairs whose
    top-k experts agree.  Pinned: the plain run takes the kernel run's
    expert ids at every layer and step (its gate weights still from its
    own router logits), so that only the attention's numerics differ; its
    greedy next tokens must agree on >= 90%, as the dense model's do (a
    routed model flips experts on one rounding of an attention output, so
    the free run tells no backend from another: PERF.md §6)."""
    from repro_torch.models import moe
    from repro_torch.serving.engine import ServingEngine

    cfg = engine.cfg
    plain = ServingEngine(cfg, params=engine.params,
                          attn_backend=PlainSplitKOnCard())
    route_topk = moe.route_topk
    routes: list = []
    pinned: list = []

    def recorded(logits, k, normalize=True):
        w, idx = route_topk(logits, k, normalize)
        routes.append(idx)
        return w, idx

    def replayed(logits, k, normalize=True):
        return pinned_route(logits, pinned.pop(0), normalize)

    stats = {run: dict(outside=0.0, rel=0.0, agree=0) for run in ("free", "pinned")}
    replay = same_experts = pairs = 0
    try:
        batch = {"tokens": torch.as_tensor(prompts, dtype=torch.int64,
                                           device=dev)}
        max_len = prompts.shape[1] + NEW
        moe.route_topk = recorded
        lk, ck = engine.model.prefill(engine.params, batch, max_len)
        caches = {}
        for run in stats:
            lp, caches[run] = plain.model.prefill(plain.params, batch, max_len)
            check(torch.equal(lk, lp),
                  "prefill logits differ under the plain backend")
        toks = torch.as_tensor(res.tokens, dtype=torch.int64, device=dev)
        for t in range(NEW):
            tok = toks[:, t:t + 1]
            moe.route_topk = recorded
            routes.clear()
            lk, ck = engine.model.decode_step(engine.params, tok, ck)
            rk = list(routes)
            routes.clear()
            lp = {}
            lp["free"], caches["free"] = plain.model.decode_step(
                plain.params, tok, caches["free"])
            for a, b in zip(rk, routes):
                same = a.sort(dim=-1).values == b.sort(dim=-1).values
                same_experts += int(same.all(dim=-1).sum())
                pairs += a.shape[0]
            moe.route_topk = replayed
            pinned[:] = rk
            lp["pinned"], caches["pinned"] = plain.model.decode_step(
                plain.params, tok, caches["pinned"])
            check(not pinned, "the pinned run used fewer routings than recorded")
            for run, st in stats.items():
                d = (lk - lp[run]).abs()
                bound = LOGITS_TOL["atol"] + LOGITS_TOL["rtol"] * lp[run].abs()
                st["outside"] = max(st["outside"], (d > bound).float().mean().item())
                st["rel"] = max(st["rel"], (d.norm() / lp[run].norm()).item())
                if t + 1 < NEW:
                    st["agree"] += int((lp[run][:, 0].argmax(-1)
                                        == toks[:, t + 1]).sum())
            if t + 1 < NEW:
                replay += int((lk[:, 0].argmax(-1) == toks[:, t + 1]).sum())
    finally:
        moe.route_topk = route_topk
    n_next = prompts.shape[0] * (NEW - 1)
    free, pin = stats["free"], stats["pinned"]
    log(f"[moe] bf16 teacher-forced, {NEW} steps, kernel vs its plain version "
        f"routing freely: worst step {free['outside']:.4%} of the logits outside "
        f"rtol=atol=3e-2 (|diff|_2/|logits|_2 {free['rel']:.3e}); greedy next "
        f"tokens equal {free['agree']} of {n_next} ({free['agree'] / n_next:.2%}); "
        f"(token, layer) pairs with the same top-{cfg.experts_per_token} experts "
        f"{same_experts} of {pairs} ({same_experts / max(1, pairs):.4%}); on {card}")
    log(f"[moe] bf16 teacher-forced, the plain run pinned to the kernel run's "
        f"experts: worst step {pin['outside']:.4%} of the logits outside "
        f"rtol=atol=3e-2 (|diff|_2/|logits|_2 {pin['rel']:.3e}); greedy next "
        f"tokens equal {pin['agree']} of {n_next} ({pin['agree'] / n_next:.2%}, "
        f">= {AGREE_MIN:.0%} required); the kernel's replay picked {replay} of "
        f"{n_next} of generate's tokens again, on {card}")
    check(replay == n_next, f"the kernel's teacher-forced replay picked "
                            f"{replay} of {n_next} tokens again")
    check(np.array_equal(lk[:, 0].cpu().numpy(), res.prefill_logits),
          "replayed last-step logits differ from generate's")
    check(pin["agree"] >= AGREE_MIN * n_next,
          f"pinned to the kernel run's experts, the plain version's greedy "
          f"next tokens agree on only {pin['agree']} of {n_next}")
    return dict(free_agree=free["agree"] / n_next, free_outside=free["outside"],
                experts_agree=same_experts / max(1, pairs),
                pinned_agree=pin["agree"] / n_next, pinned_outside=pin["outside"])


def moe_stream(engine, dev, card) -> dict:
    """A short stream (``MOE_STREAM``) through the scheduler's graphed step,
    each slot routed as its own group: graph = eager bit for bit, each
    request bit for bit itself served alone."""
    import dataclasses

    from repro_torch.serving.scheduler import RequestScheduler

    n, slots, prompts, budgets = MOE_STREAM
    cfg = engine.cfg
    reqs = cb_requests(n, prompts, budgets, 4, cfg.vocab_size, SEED)
    layout = engine.cache_layout(prompts[1] + budgets[1])
    cap = layout.padded_len(prompts[1] + budgets[1])

    def scheduler(graph):
        return RequestScheduler(engine.model, engine.params, slots, cap,
                                layout=layout, device=dev, graph=graph)

    t = time.perf_counter()
    sched = scheduler(True)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t
    res, wall, ms = drive(sched, reqs)
    steps, tokens = sched.steps_run, sched.tokens_emitted
    eager = scheduler(False)
    reset_counts()
    res_e, wall_e, ms_e = drive(eager, reqs)
    counts = read_counts()
    want = only(counts, **stream_launches(cfg, eager.steps_run))
    check(counts == want, f"moe eager stream launches {counts}, want {want}")
    check(sched.gather_steps == eager.gather_steps == 0,
          f"moe stream gather_steps {sched.gather_steps}, {eager.gather_steps}")
    same_results(res, res_e, "moe graph vs eager")
    for r in reqs:
        solo = {x.rid: x for x in sched.run([dataclasses.replace(r, arrival=0)])}
        same_results({r.rid: res[r.rid]}, solo, "moe stream vs solo")
    check(sched.captures == 1, f"{sched.captures} captures")
    log(f"[stream] {cfg.name}: {n} requests (prompts "
        f"{[len(r.prompt) for r in reqs]}, budgets "
        f"{[r.max_new_tokens for r in reqs]}) through {slots} slots of "
        f"capacity {cap}, one token group a slot: {steps} steps, {tokens} "
        f"tokens; scheduler built and captured in {t_build:.2f} s; graph = "
        f"eager bit for bit ({counts['decode_attention_paged']} = "
        f"{cfg.n_layers} x {eager.steps_run} paged decode kernels eager, "
        f"gather_steps {sched.gather_steps}); each request bit for bit "
        f"itself served alone; ms a step graph {statistics.median(ms):.3f}, "
        f"eager {statistics.median(ms_e):.3f}; stream wall graph {wall:.3f} s "
        f"({tokens / wall:.1f} tokens/s), eager {wall_e:.3f} s "
        f"({tokens / wall_e:.1f} tokens/s); captures {sched.captures}, on {card}")
    return dict(steps=steps, tokens=tokens,
                step_ms_graph=statistics.median(ms),
                step_ms_eager=statistics.median(ms_e))


def ep_on(mesh) -> None:
    """Expert parallelism on over ``mesh``'s model axis."""
    from repro_torch.launch.mesh import mesh_axes_of
    from repro_torch.models import layers as L
    from repro_torch.models import moe

    ax = mesh_axes_of(mesh)
    L.set_shard_ctx(mesh, ax.dp, ax.model)
    moe.set_moe_ep_shardmap(True)


def ep_off() -> None:
    from repro_torch.models import layers as L
    from repro_torch.models import moe

    L.set_shard_ctx()
    moe.set_moe_ep_shardmap(False)


def ep_layer_check(engine, prompts, res, mesh, dev, card) -> dict:
    """One moe layer (the first) at its real inputs, a prefill of one
    prompt of ``PROMPT`` tokens and phase 9's first decode step (B 8),
    through ``moe_ffn_dispatch`` with EP on against ``moe_ffn``: bf16 at
    ``EP_TOL``; the layer's weights widened to fp32, within
    ``EP_FP32_REL`` of the largest |out| with every shard routing each
    token to ``moe_ffn``'s experts.  Each shard's expert weights must be
    views of the stacks (their addresses)."""
    from repro_torch.models import moe

    cfg = engine.cfg
    real = moe.moe_ffn_dispatch
    seen = []

    def grab(p, x, *a, **k):
        if p is engine.params.moe_blocks[0].moe:
            seen.append(x.detach().clone())
        return real(p, x, *a, **k)

    moe.moe_ffn_dispatch = grab
    try:
        batch = {"tokens": torch.as_tensor(prompts, dtype=torch.int64, device=dev)}
        _, cache = engine.model.prefill(engine.params, batch, PROMPT + NEW)
        tok = torch.as_tensor(res.tokens[:, :1], dtype=torch.int64, device=dev)
        engine.model.decode_step(engine.params, tok, cache)
        del cache
        engine.model.prefill(engine.params, {"tokens": batch["tokens"][:1]},
                             PROMPT + NEW)
    finally:
        moe.moe_ffn_dispatch = real
    xs = {"decode": seen[1], "prefill": seen[2]}
    p = engine.params.moe_blocks[0].moe
    M = mesh.shape["model"]
    E_local = cfg.n_experts // M
    for m in range(M):
        for name, t in moe._expert_slice(p, m * E_local, E_local, dev).items():
            check(t.data_ptr() == getattr(p, name)[m * E_local].data_ptr(),
                  f"shard {m}'s {name} is not a view of the stacked experts")
    p32 = moe.MoeFfn(cfg, dtype=torch.float32, device=dev)
    for name, dst in p32.named_parameters():
        dst.copy_(p.get_parameter(name))
    route_topk = moe.route_topk
    routes: list = []

    def recorded(logits, k, normalize=True):
        w, idx = route_topk(logits, k, normalize)
        routes.append(idx)
        return w, idx

    out = {}
    try:
        for tag, x in xs.items():
            ep_off()
            want, _ = moe.moe_ffn(p, x, cfg)
            ep_on(mesh)
            got, _ = moe.moe_ffn_dispatch(p, x, cfg)
            err = (got.float() - want.float()).abs().max().item()
            torch.testing.assert_close(got.float(), want.float(), **EP_TOL)
            ep_off()
            moe.route_topk = recorded
            routes.clear()
            want32, _ = moe.moe_ffn(p32, x.float(), cfg)
            ep_on(mesh)
            got32, _ = moe.moe_ffn_shardmap(p32, x.float(), cfg)
            moe.route_topk = route_topk
            ep_off()
            scale = want32.abs().max().item()
            err32 = (got32 - want32).abs().max().item()
            check(err32 <= EP_FP32_REL * scale,
                  f"EP {tag}, fp32: max |diff| {err32:.3e} > {EP_FP32_REL} x "
                  f"{scale:.3e}")
            check(len(routes) == 1 + M
                  and all(torch.equal(r, routes[0]) for r in routes[1:]),
                  f"EP {tag}: a shard routed a token to other experts")
            out[tag] = dict(bf16_err=err, fp32_err=err32, fp32_scale=scale)
            log(f"[ep] {cfg.name}'s first moe layer at its {tag} input "
                f"{list(x.shape)}, EP over {M} model shards ([cuda:0] x {M}): "
                f"bf16 max |diff| against moe_ffn {err:.3e} (tolerance "
                f"{EP_TOL['atol']}); fp32 (the layer widened) {err32:.3e} of "
                f"the largest |out| {scale:.3f} (<= {EP_FP32_REL} x it); every "
                f"shard routed every token to moe_ffn's top-"
                f"{cfg.experts_per_token}, on {card}")
    finally:
        moe.route_topk = route_topk
        ep_off()
    del p32
    torch.cuda.empty_cache()
    return out


def ep_teacher_forced(engine, prompts, res, mesh, dev) -> dict:
    """``res``'s run with EP off recorded (every routing, prefill and 32
    steps), then teacher-forced on its tokens with EP on: pinned (every
    model shard of a layer takes the recorded expert ids, its gate weights
    from its own router logits) and free.  Returns the shares of greedy
    next tokens equal to ``res``'s and of (token, layer) pairs whose top-k
    experts agree (free)."""
    from repro_torch.models import moe

    M = mesh.shape["model"]
    route_topk = moe.route_topk
    routes: list = []
    pinned: list = []
    calls = [0]

    def recorded(logits, k, normalize=True):
        w, idx = route_topk(logits, k, normalize)
        routes.append(idx)
        return w, idx

    def replayed(logits, k, normalize=True):
        idx = pinned[calls[0] // M]
        calls[0] += 1
        return pinned_route(logits, idx, normalize)

    batch = {"tokens": torch.as_tensor(prompts, dtype=torch.int64, device=dev)}
    toks = torch.as_tensor(res.tokens, dtype=torch.int64, device=dev)
    max_len = prompts.shape[1] + NEW

    def forced(route):
        moe.route_topk = route
        logits, cache = engine.model.prefill(engine.params, batch, max_len)
        agree, steps = 0, []
        for t in range(NEW):
            n0 = len(routes)
            logits, cache = engine.model.decode_step(engine.params,
                                                     toks[:, t:t + 1], cache)
            steps.append(routes[n0:])
            if t + 1 < NEW:
                agree += int((logits[:, 0].argmax(-1) == toks[:, t + 1]).sum())
        return agree, steps, logits

    try:
        ep_off()
        _, off_steps, off_logits = forced(recorded)
        check(np.array_equal(off_logits[:, 0].cpu().numpy(), res.prefill_logits),
              "EP off, teacher-forced, last logits differ from generate's")
        pinned[:] = list(routes)
        routes.clear()
        ep_on(mesh)
        pin_agree, _, _ = forced(replayed)
        check(calls[0] == M * len(pinned),
              f"the pinned run routed {calls[0]} times, want {M} x {len(pinned)}")
        routes.clear()
        free_agree, free_steps, _ = forced(recorded)
    finally:
        moe.route_topk = route_topk
        ep_off()
    same = pairs = 0
    for a_step, b_step in zip(off_steps, free_steps):
        for i, a in enumerate(a_step):
            b = b_step[i * M]
            same += int((a.sort(dim=-1).values == b.sort(dim=-1).values)
                        .all(dim=-1).sum())
            pairs += a.shape[0]
    n_next = prompts.shape[0] * (NEW - 1)
    check(pin_agree >= AGREE_MIN * n_next,
          f"EP on, pinned to EP off's experts: {pin_agree} of {n_next} next "
          f"tokens equal")
    return dict(pinned_agree=pin_agree / n_next, free_agree=free_agree / n_next,
                experts_agree=same / max(1, pairs), n_next=n_next,
                pinned_n=pin_agree, free_n=free_agree, same=same, pairs=pairs)


def ep_phase(engine, prompts, res, dev, card) -> dict:
    """Phase 16: deepseek-moe-16b at full width with expert parallelism
    over a ``EP_MESH`` ``("data", "model")`` mesh of the card
    (``set_shard_ctx``): the layer check (``ep_layer_check``); ``generate``
    with EP on against EP off, teacher-forced pinned to EP off's experts
    (>= ``AGREE_MIN`` of next tokens), expert sets reported; peak memory
    with EP on within ``EP_PEAK_GB`` of EP off (the shards' expert weights
    are views); then the sequence-sharded stream at D 2 (EP off):
    graph = eager bit for bit.  Returns the numbers."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serving.scheduler import RequestScheduler

    cfg = engine.cfg
    mesh = make_mesh(EP_MESH, ("data", "model"), [dev] * math.prod(EP_MESH))
    layer = ep_layer_check(engine, prompts, res, mesh, dev, card)
    peaks, gens = {}, {}
    try:
        for tag in ("off", "on"):
            ep_on(mesh) if tag == "on" else ep_off()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            gens[tag] = engine.generate(prompts, max_new_tokens=NEW)
            torch.cuda.synchronize()
            peaks[tag] = (torch.cuda.max_memory_allocated(), time.perf_counter() - t)
    finally:
        ep_off()
    check(np.array_equal(gens["off"].tokens, res.tokens),
          "EP off, generate's tokens differ from phase 9's")
    share = float((gens["on"].tokens == res.tokens).mean())
    grow = (peaks["on"][0] - peaks["off"][0]) / 1e9
    check(grow <= EP_PEAK_GB, f"EP on peaks {grow:.2f} GB above EP off")
    forced = ep_teacher_forced(engine, prompts, res, mesh, dev)
    log(f"[ep] generate (B {SERVE_BATCH}, prompt {PROMPT}, {NEW} new) with EP "
        f"on over {EP_MESH} ('data', 'model') of the card: peak "
        f"{peaks['on'][0] / 1e9:.2f} GB against EP off's {peaks['off'][0] / 1e9:.2f} "
        f"({grow:+.2f} GB, <= {EP_PEAK_GB} required: the shards' experts are "
        f"views); host wall {peaks['on'][1]:.3f} s against {peaks['off'][1]:.3f}; "
        f"free-running tokens equal to EP off's {share:.2%}; teacher-forced on "
        f"EP off's tokens: pinned to its experts {forced['pinned_n']} of "
        f"{forced['n_next']} next tokens equal ({forced['pinned_agree']:.2%}, "
        f">= {AGREE_MIN:.0%} required), free {forced['free_n']} "
        f"({forced['free_agree']:.2%}), (token, layer) pairs with the same "
        f"experts {forced['same']} of {forced['pairs']} "
        f"({forced['experts_agree']:.4%}), on {card}")

    # the sequence-sharded stream at D 2 over deepseek (EP off)
    n, slots, plens, budgets = MOE_STREAM
    reqs = cb_requests(n, plens, budgets, 4, cfg.vocab_size, SEED)
    layout = engine.cache_layout(MOE_MESH_CAP)
    cap = layout.padded_len(MOE_MESH_CAP)
    d = 2

    def scheduler(mesh_d, graph):
        return RequestScheduler(engine.model, engine.params, slots, cap,
                                layout=layout, device=dev, graph=graph,
                                mesh=None if mesh_d is None else mesh_of(mesh_d, dev))

    res_u, _, _ = drive(scheduler(None, True), reqs)
    sched = scheduler(d, True)
    res_g, wall_g, ms_g = drive(sched, reqs)
    eager = scheduler(d, False)
    reset_counts()
    res_e, wall_e, ms_e = drive(eager, reqs)
    counts = read_counts()
    want = only(counts, decode_attention=cfg.n_layers * d * eager.steps_run)
    check(counts == want, f"moe D {d} eager stream launches {counts}, want {want}")
    same_results(res_g, res_e, f"moe D {d} graph vs eager")
    check(sched.captures == 1, f"moe D {d}: {sched.captures} captures")
    tshare = token_share(res_g, res_u)
    log(f"[stream-mesh] {cfg.name}, {n} requests through {slots} slots of "
        f"capacity {cap} at D {d} ([cuda:0] x {d}): graph = eager bit for bit; "
        f"{counts['decode_attention']} = {cfg.n_layers} x {d} x "
        f"{eager.steps_run} decode kernels eager; ms a step graph "
        f"{statistics.median(ms_g):.3f}, eager {statistics.median(ms_e):.3f}; "
        f"tokens equal to the unsharded stream's {tshare:.2%}, on {card}")
    del sched, eager
    torch.cuda.empty_cache()
    return dict(layer=layer, peak_off_gb=peaks["off"][0] / 1e9,
                peak_on_gb=peaks["on"][0] / 1e9, generate_share=share,
                teacher_forced=forced, stream_d2=dict(
                    step_ms_graph=statistics.median(ms_g),
                    step_ms_eager=statistics.median(ms_e), token_share=tshare,
                    launches=counts["decode_attention"]))


def moe_phase(dev, peaks, card):
    """deepseek-moe-16b at full width (28 layers, 64 routed experts of 1408
    and 2 shared, top-6; bf16 params drawn on the card from seed 0; fp32 KV
    cache).  Returns (the decode kernel's launches in ``generate``, the
    numbers, the kernel's max error at deepseek's shape)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.faas.lm_pipeline import run_lm_pipeline
    from repro_torch.models import moe
    from repro_torch.serving.engine import ServingEngine

    cfg = get_config(MOE_ARCH)
    t = time.time()
    engine = ServingEngine(cfg, seed=SEED)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in engine.params.parameters())
    p_bytes = sum(p.numel() * p.element_size() for p in engine.params.parameters())
    log(f"[moe] {cfg.name}: {cfg.n_layers} layers ({cfg.first_dense_layers} "
        f"dense, d_ff {cfg.d_ff}), d_model {cfg.d_model}, {cfg.n_heads} heads / "
        f"{cfg.n_kv_heads} KV heads, d_head {cfg.d_head}, {cfg.n_experts} routed "
        f"experts of {cfg.moe_d_ff} and {cfg.n_shared_experts} shared, top-"
        f"{cfg.experts_per_token}, capacity factor {cfg.moe_capacity_factor}; "
        f"{n_params / 1e9:.3f} B params ({p_bytes / 1e9:.2f} GB, bf16, router "
        f"fp32) drawn on the card from seed {SEED} in {time.time() - t:.1f} s; "
        f"KV cache {moe.DECODE_CACHE_DTYPE}; backend {engine.attn_backend.name}")
    rng = np.random.default_rng(1)
    prompts = rng.integers(0, cfg.vocab_size,
                           size=(SERVE_BATCH, PROMPT)).astype(np.int32)
    engine.generate(prompts[:, :16], max_new_tokens=2)  # warm-up
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = engine.generate(prompts, max_new_tokens=NEW)
    t_first = time.perf_counter() - t
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    want = only(launches, decode_attention=cfg.n_layers * NEW)
    check(launches == want, f"moe serving launches {launches}, want {want}")
    V = cfg.padded_vocab()
    check(res.tokens.shape == (SERVE_BATCH, NEW)
          and bool(((res.tokens >= 0) & (res.tokens < V)).all()),
          f"tokens {res.tokens.shape} out of range")
    check(bool(np.isfinite(res.prefill_logits).all()), "logits not finite")
    log(f"[moe] generate(B {SERVE_BATCH}, prompt {PROMPT}, {NEW} new): "
        f"{t_first:.3f} s host wall (first timed run); decode kernel launches "
        f"{launches['decode_attention']} = {cfg.n_layers} x {NEW} (fp32, G 1); "
        f"peak device memory {peak / 1e9:.2f} GB; first tokens "
        f"{res.tokens[0, :8].tolist()}")

    def wall(n_new, reps=2):
        ts = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine.generate(prompts, max_new_tokens=n_new)
            ts.append(time.perf_counter() - t0)
        return statistics.median(ts)

    t_prefill, t_gen = wall(0), wall(NEW)
    step = (t_gen - t_prefill) / NEW
    log(f"[moe] prefill {t_prefill * 1e3:.2f} ms (median of 2 generate(..., "
        f"0)); generate {t_gen * 1e3:.2f} ms (median of 2); decode "
        f"{step * 1e3:.3f} ms/step, {SERVE_BATCH / step:.1f} tokens/s; end to "
        f"end {SERVE_BATCH * NEW / t_gen:.1f} tokens/s, on {card}")
    profile_decode(engine, prompts, step * 1e3)
    S = engine.cache_layout(PROMPT + NEW).padded_len(PROMPT + NEW)
    timing, err = moe_kernel(dev, peaks, card, cfg, S)
    forced = moe_teacher_forced(engine, prompts, res, dev, card)

    # the pipeline at P 4 on the queue channel
    B, Sp, new = MOE_PIPE
    short = prompts[:B, :Sp]
    ref = engine.generate(short, max_new_tokens=new)
    reset_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    pipe = run_lm_pipeline(cfg, short, engine.params, max_new_tokens=new,
                           P=PIPE_P, channel="queue",
                           attn_backend=engine.attn_backend)
    t_pipe = time.perf_counter() - t
    counts = read_counts()
    check(counts == only(counts, decode_attention=cfg.n_layers * new),
          f"moe pipeline launches {counts}")
    same_generation(pipe, ref, "moe pipeline vs the device engine")
    log(f"[moe] pipeline P {PIPE_P} ({[s.n_layers for s in pipe.plan.stages]} "
        f"layers a stage), queue, batch {B}, prompts of {Sp}, {new} new: tokens "
        f"and logits bit for bit the device engine's; {counts['decode_attention']}"
        f" = {cfg.n_layers} x {new} decode kernels; {t_pipe:.3f} s host wall, "
        f"makespan {pipe.makespan:.4f} s, cost {pipe.cost.total:.6e} USD, "
        f"messages {pipe.metrics.get('messages', 0):.0f}, on {card}")
    stream = moe_stream(engine, dev, card)
    t = time.time()
    ep = ep_phase(engine, prompts, res, dev, card)
    log(f"[ep] phase 16 {time.time() - t:.1f} s")

    # fp32, cut to MOE_CUT layers at full width: the card against the CPU
    cut = dataclasses.replace(cfg, n_layers=MOE_CUT)
    p32 = moe.Moe(cut, dtype=torch.float32, device=dev)
    for name, dst in p32.named_parameters():
        dst.copy_(engine.params.get_parameter(name))
    del engine
    torch.cuda.empty_cache()
    cpu = moe.Moe(cut, dtype=torch.float32, device="cpu")
    for dst, src in zip(cpu.parameters(), p32.parameters()):
        dst.copy_(src.cpu())
    cut_bytes = sum(p.numel() * 4 for p in p32.parameters())
    Bc, Sc, newc = MOE_CPU
    short = prompts[:Bc, :Sc]
    t = time.time()
    a = ServingEngine(cut, params=p32).generate(short, max_new_tokens=newc)
    t_card = time.time() - t
    t = time.time()
    b = ServingEngine(cut, params=cpu, device="cpu").generate(
        short, max_new_tokens=newc)
    t_cpu = time.time() - t
    check(np.array_equal(a.tokens, b.tokens),
          f"fp32 tokens differ, card {a.tokens} vs cpu {b.tokens}")
    err32 = float(np.abs(a.prefill_logits - b.prefill_logits).max())
    np.testing.assert_allclose(a.prefill_logits, b.prefill_logits, **E2E_TOL)
    log(f"[moe] fp32 params cut to {MOE_CUT} layers ({cut.first_dense_layers} "
        f"dense, {MOE_CUT - cut.first_dense_layers} moe; a depth cut, the "
        f"widths full; {cut_bytes / 1e9:.2f} GB), B {Bc}, prompt {Sc}, {newc} "
        f"new tokens: card and CPU tokens identical {a.tokens.tolist()}; "
        f"last-step max |logits diff| {err32:.3e} (tolerance 1e-4; logits std "
        f"{float(b.prefill_logits.std()):.3f}); card {t_card:.1f} s, CPU "
        f"{t_cpu:.1f} s host wall")
    del p32, cpu
    torch.cuda.empty_cache()
    summary = dict(prefill_ms=t_prefill * 1e3, step_ms=step * 1e3,
                   tokens_per_s=SERVE_BATCH / step, peak_gb=peak / 1e9,
                   pipeline_wall_s=t_pipe, stream=stream, fp32_cut_err=err32,
                   teacher_forced=forced, expert_parallel=ep)
    return launches["decode_attention"], timing, summary, err


# ---------------------------------------------------------------------------
# 10-12. zamba2-7b (hybrid), seamless-m4t-medium (encdec), internvl2-2b (vlm)
# ---------------------------------------------------------------------------


def frontend(cfg, B: int, seed: int):
    """The stub frontend's input for ``B`` rows, normal from ``seed``:
    ``{"extra_embeds"}`` (vlm), ``{"frames"}`` (encdec), else None."""
    from repro_torch.models.registry import FRONTEND_INPUTS

    key = FRONTEND_INPUTS.get(cfg.family)
    if key is None:
        return None
    rng = np.random.default_rng(seed)
    return {key: rng.standard_normal((B, cfg.frontend_tokens, cfg.d_model))
            .astype(np.float32)}


def stream_launches(cfg, steps: int) -> dict:
    """The decode-kernel launches of ``steps`` eager steps of the scheduler
    on one device: the paged form's for the growing self-attention, the
    contiguous form's for the encdec family's cross attention."""
    cross = cfg.n_layers if cfg.family == "encdec" else 0
    return dict(decode_attention=cross * steps,
                decode_attention_paged=(launches_a_step(cfg) - cross) * steps)


def launches_a_step(cfg) -> int:
    """Decode-kernel launches of one decode step: one a shared-attention
    site (hybrid), two a decoder layer (encdec: self and cross), else one a
    layer."""
    from repro_torch.models import hybrid

    if cfg.family == "hybrid":
        return hybrid.n_shared_sites(cfg)
    return cfg.n_layers * (2 if cfg.family == "encdec" else 1)


def path_kernel(dev, peaks, card, tag, shape, L, dtypes, timed):
    """The decode kernel at one of a path's shapes ``(B, H, KV, S, D)``:
    held to its plain version in each of ``dtypes`` at cache lengths 0, 1,
    each split's first and last key +-1, ``L`` and the capacity, then (the
    dtypes in ``timed``) timed at ``L``: single calls, 50 back to back,
    from a CUDA graph and by profiler device time, beside the plain
    version, SDPA and the bound.  Returns ({dtype: timing}, max error)."""
    from repro_torch.kernels.decode_attention import ops, ref

    B, H, KV, S, D = shape
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    out_t, worst = {}, 0.0
    for dtype in dtypes:
        q, k, v = [torch.randn(s, generator=gen, device=dev, dtype=dtype)
                   for s in ((B, H, D), (B, KV, S, D), (B, KV, S, D))]
        n_split, split_keys = ops.plan_for(q, k)
        lens = {0, 1, L, S}
        for j in range(n_split):
            for e in (j * split_keys, min((j + 1) * split_keys, S) - 1):
                lens.update((e - 1, e, e + 1))
        tol = DECODE_TOL[dtype]
        errs = []
        for n in sorted(x for x in lens if 0 <= x <= S):
            lt = torch.tensor([n], dtype=torch.int32, device=dev)
            out, lse = ops.decode_mha(q, k, v, lt)
            want, want_lse = ref.decode_attention_ref(q, k, v, lt)
            torch.testing.assert_close(out.float(), want.float(), **tol,
                                       msg=lambda m: f"{tag} L={n}: {m}")
            torch.testing.assert_close(lse, want_lse, **tol,
                                       msg=lambda m: f"{tag} L={n} lse: {m}")
            errs.append((out.float() - want.float()).abs().max().item())
        worst = max(worst, max(errs))
        log(f"  decode {tag} B{B} H{H} KV{KV} S{S} D{D} {dtype}, {n_split} "
            f"splits of {split_keys} keys, {len(errs)} cache lengths (0, 1, "
            f"each split's edges +-1, {L}, {S}): max_abs_err out {max(errs):.3e}"
            f" (tolerance rtol=atol={tol['atol']})")
        if dtype not in timed:
            continue
        lt = torch.tensor([L], dtype=torch.int32, device=dev)
        kernel = lambda: ops.decode_mha(q, k, v, lt)  # noqa: E731
        library = sdpa_call(q, k, v, L)
        lib_err = (library().float() - kernel()[0].float()).abs().max().item()
        ms = time_ms(kernel, reps=20)
        plain_ms = time_ms(lambda: ref.decode_attention_ref(q, k, v, lt),
                           reps=20)
        lib_ms = time_ms(library, reps=20)
        extra = back_to_back("decode_attention", f"{tag} {dtype} cache_len {L}",
                             kernel, library)
        b_ms, b_by, nbytes, flops = decode_bound(B, H, KV, L, D, dtype, peaks)
        log(f"[time] decode_attention {tag} B{B} H{H} KV{KV} S{S} D{D} {dtype} "
            f"cache_len {L}: kernel {ms:.4f} ms, {extra['graph_ms']:.4f} from a "
            f"CUDA graph, plain {plain_ms:.4f} ms, library (SDPA) {lib_ms:.4f} "
            f"ms, {extra['library_graph_ms']:.4f} from a CUDA graph (max "
            f"|library - kernel| {lib_err:.3e}), bound {b_ms:.4f} ms by {b_by} "
            f"({nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP), on {card}")
        out_t[str(dtype).split(".")[-1]] = dict(
            shape=[B, H, KV, S, D], cache_len=L, ms=ms, plain_ms=plain_ms,
            library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by, **extra)
        del q, k, v
    torch.cuda.empty_cache()
    return out_t, worst


def clone_tree(tree):
    """A copy of a cache tree (dicts and lists of tensors)."""
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [clone_tree(v) for v in tree]
    return tree.clone()


class CheckedKernel:
    """The kernel backend, each call also run through the kernel's plain
    version on the same inputs and held to it (``DECODE_TOL``): the
    kernel at the model's own q, K and V.  Returns the kernel's output."""

    def __init__(self, kernel):
        self.kernel, self.plain = kernel, PlainSplitKOnCard()
        self.name, self.calls, self.worst = kernel.name, 0, 0.0

    def cache_layout(self, max_len):
        return self.kernel.cache_layout(max_len)

    def decode(self, q, k_cache, v_cache, cache_len):
        out = self.kernel.decode(q, k_cache, v_cache, cache_len)
        want = self.plain.decode(q, k_cache, v_cache, cache_len)
        torch.testing.assert_close(out.float(), want.float(),
                                   **DECODE_TOL[q.dtype])
        self.worst = max(self.worst, (out.float() - want.float()).abs().max().item())
        self.calls += 1
        return out


def teacher_forced(engine, batch, res, max_len: int, card,
                   logit_gate: bool) -> dict:
    """Teacher-forced on ``res``'s tokens in bf16, the kernel against the
    same params through its plain version on the card
    (``PlainSplitKOnCard``).  Every kernel call of the run is held to the
    plain version on its own inputs (``CheckedKernel``).  Pinned: each step
    of the plain version starts from a copy of the kernel run's cache, so
    that the two differ by one step's attention numerics; free: the plain
    version runs on its own cache, so differences accumulate over the
    steps.  Both are held to the dense gate (at most
    ``LOGITS_OUTSIDE_MAX`` of a step's logits outside 3e-2, ``AGREE_MIN``
    of the greedy next tokens equal) where ``logit_gate``; otherwise the
    pinned run's next tokens are held to ``AGREE_MIN`` and the rest is
    reported.  Beside them ``dense-ref`` runs free against the plain
    version (two implementations without the kernel, ``dense-ref`` rounding
    p to bf16 as the reference's oracle does): how far the model itself
    carries a rounding.  The kernel's replay must pick generate's tokens
    again."""
    from repro_torch.serving.engine import ServingEngine

    cfg = engine.cfg
    checked = CheckedKernel(engine.attn_backend)
    engine = ServingEngine(cfg, params=engine.params, attn_backend=checked)
    plain = ServingEngine(cfg, params=engine.params,
                          attn_backend=PlainSplitKOnCard())
    dense = ServingEngine(cfg, params=engine.params, attn_backend="dense-ref")
    lk, ck = engine.model.prefill(engine.params, batch, max_len)
    lp, cp = plain.model.prefill(plain.params, batch, max_len)
    ld, cd = dense.model.prefill(dense.params, batch, max_len)
    check(torch.equal(lk, lp) and torch.equal(lk, ld),
          "prefill logits differ under the plain backends")
    toks = torch.as_tensor(res.tokens, dtype=torch.int64, device=lk.device)
    new = toks.shape[1]
    pairs = ("pinned", "free", "dense-ref free")
    st = {p: dict(outside=0.0, rel=0.0, max_abs=0.0, agree=0) for p in pairs}
    replay = 0
    for t in range(new):
        tok = toks[:, t:t + 1]
        before = clone_tree(ck)
        lk, ck = engine.model.decode_step(engine.params, tok, ck)
        lpin, _ = plain.model.decode_step(plain.params, tok, before)
        del before
        lp, cp = plain.model.decode_step(plain.params, tok, cp)
        ld, cd = dense.model.decode_step(dense.params, tok, cd)
        for name, (a, b) in zip(pairs, ((lk, lpin), (lk, lp), (ld, lp))):
            d = (a - b).abs()
            bound = LOGITS_TOL["atol"] + LOGITS_TOL["rtol"] * b.abs()
            s_ = st[name]
            s_["outside"] = max(s_["outside"], (d > bound).float().mean().item())
            s_["rel"] = max(s_["rel"], (d.norm() / b.norm()).item())
            s_["max_abs"] = max(s_["max_abs"], d.max().item())
        if t + 1 < new:
            nxt = toks[:, t + 1]
            replay += int((lk[:, 0].argmax(-1) == nxt).sum())
            for name, lo in zip(pairs, (lpin, lp, ld)):
                st[name]["agree"] += int((lo[:, 0].argmax(-1) == nxt).sum())
    n_next = toks.shape[0] * (new - 1)
    log(f"[{cfg.family}] bf16 teacher-forced: {checked.calls} kernel calls, "
        f"each held to the plain version on its own inputs: max_abs_err "
        f"{checked.worst:.3e} (tolerance rtol=atol="
        f"{DECODE_TOL[torch.bfloat16]['atol']})")
    for name in pairs:
        s_ = st[name]
        gated = logit_gate and name != "dense-ref free"
        what = ("the kernel vs its plain version" if name != "dense-ref free"
                else "dense-ref vs the plain version (no kernel)")
        log(f"[{cfg.family}] bf16 teacher-forced, {new} steps, {name}: {what}: "
            f"worst step {s_['outside']:.4%} of the logits outside rtol=atol="
            f"3e-2 (max |diff| {s_['max_abs']:.3e}, |diff|_2/|logits|_2 "
            f"{s_['rel']:.3e}); greedy next tokens equal {s_['agree']} of "
            f"{n_next} ({s_['agree'] / n_next:.2%})"
            + (f"; gate <= {LOGITS_OUTSIDE_MAX:.0%} outside, >= "
               f"{AGREE_MIN:.0%} equal" if gated
               else f"; gate >= {AGREE_MIN:.0%} equal" if name == "pinned"
               else "; reported")
            + f", on {card}")
    check(replay == n_next, f"the kernel's teacher-forced replay picked "
                            f"{replay} of {n_next} tokens again")
    check(np.array_equal(lk[:, 0].cpu().numpy(), res.prefill_logits),
          "replayed last-step logits differ from generate's")
    for name in ("pinned", "free") if logit_gate else ("pinned",):
        check(not logit_gate or st[name]["outside"] <= LOGITS_OUTSIDE_MAX,
              f"{name}: {st[name]['outside']:.3%} of a step's logits differ "
              f"from the plain version's by more than rtol=atol=3e-2")
        check(st[name]["agree"] >= AGREE_MIN * n_next,
              f"{name}: the plain version's greedy next tokens agree on only "
              f"{st[name]['agree']} of {n_next}")
    out = {name: dict(outside=v["outside"], rel_l2=v["rel"],
                      agree=v["agree"] / n_next) for name, v in st.items()}
    out["kernel_calls"], out["kernel_max_err"] = checked.calls, checked.worst
    return out


def family_stream(engine, dev, card) -> dict:
    """``FAMILY_STREAM`` through the scheduler's graphed step, each request
    with its frontend input: graph = eager bit for bit (the eager stream's
    decode launches counted), each request bit for bit itself alone."""
    import dataclasses

    from repro_torch.serving.scheduler import RequestScheduler

    n, slots, prompts, budgets = FAMILY_STREAM
    cfg = engine.cfg
    reqs = cb_requests(n, prompts, budgets, 4, cfg.vocab_size, SEED)
    for r in reqs:
        r.extra = frontend(cfg, 1, SEED + 10 + r.rid)
    need = prompts[1] + budgets[1] + (cfg.frontend_tokens or 0)
    layout = engine.cache_layout(need)
    cap = layout.padded_len(need)

    def scheduler(graph):
        return RequestScheduler(engine.model, engine.params, slots, cap,
                                layout=layout, device=dev, graph=graph)

    t = time.perf_counter()
    sched = scheduler(True)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t
    res, wall, ms = drive(sched, reqs)
    steps, tokens = sched.steps_run, sched.tokens_emitted
    eager = scheduler(False)
    reset_counts()
    res_e, wall_e, ms_e = drive(eager, reqs)
    counts = read_counts()
    want = only(counts, **stream_launches(cfg, eager.steps_run))
    check(counts == want, f"{cfg.name} eager stream launches {counts}, want {want}")
    check(sched.gather_steps == eager.gather_steps == 0,
          f"{cfg.name} stream gather_steps {sched.gather_steps}, "
          f"{eager.gather_steps}")
    same_results(res, res_e, f"{cfg.name} graph vs eager")
    for r in reqs:
        solo = {x.rid: x for x in sched.run([dataclasses.replace(r, arrival=0)])}
        same_results({r.rid: res[r.rid]}, solo, f"{cfg.name} stream vs solo")
    check(sched.captures == 1, f"{sched.captures} captures")
    log(f"[stream] {cfg.name}: {n} requests (prompts "
        f"{[len(r.prompt) for r in reqs]}, budgets "
        f"{[r.max_new_tokens for r in reqs]}"
        + (f", each with its {cfg.frontend_tokens} frontend rows" if reqs[0].extra
           else "") + f") through {slots} slots of capacity {cap}: {steps} "
        f"steps, {tokens} tokens; scheduler built and captured in "
        f"{t_build:.2f} s; graph = eager bit for bit "
        f"({counts} decode kernels over {eager.steps_run} eager steps, "
        f"gather_steps {sched.gather_steps}); each request bit for bit "
        f"itself served alone; ms a step graph {statistics.median(ms):.3f}, "
        f"eager {statistics.median(ms_e):.3f}; stream wall graph {wall:.3f} s "
        f"({tokens / wall:.1f} tokens/s), eager {wall_e:.3f} s "
        f"({tokens / wall_e:.1f} tokens/s); captures {sched.captures}, on {card}")
    return dict(steps=steps, tokens=tokens, step_ms_graph=statistics.median(ms),
                step_ms_eager=statistics.median(ms_e), wall_s_graph=wall,
                wall_s_eager=wall_e)


def vlm_pipeline(engine, prompts, embeds, card) -> tuple:
    """``run_lm_pipeline`` with the image embeddings as ``extra`` at P
    ``PIPE_P`` (``FAMILY_PHASES``' pipeline batch, prompt and new tokens)
    on the queue and the object channel, each with both clocks: tokens and
    logits bit for bit the device engine's, the decode kernel once a layer
    a step, every billed count equal between the clocks.  Returns (the
    decode kernel's launches in one run, the numbers)."""
    from repro_torch.faas.lm_pipeline import build_stage_executors

    cfg = engine.cfg
    B, S, new = FAMILY_PHASES[cfg.name]["pipeline"]
    short, emb = prompts[:B, :S], embeds[:B]
    want = engine.generate(short, max_new_tokens=new,
                           extra={"extra_embeds": emb})
    executors = build_stage_executors(cfg, engine.params, PIPE_P,
                                      attn_backend=engine.attn_backend)
    spans: list = []
    timed_stages(executors, spans)
    summary = {}
    for ch in ("queue", "object"):
        runs = {}
        for overlap in (True, False):
            res, counts, wall, stage = pipeline_run(
                cfg, short, engine.params, executors, spans, new, P=PIPE_P,
                channel=ch, overlap=overlap, extra=emb)
            want_counts = only(counts, decode_attention=cfg.n_layers * new)
            check(counts == want_counts, f"vlm pipeline {ch}: launches {counts}")
            same_generation(res, want, f"vlm pipeline {ch} vs the device engine")
            check(int(executors[0].cache["length"]) == cfg.frontend_tokens + S + new,
                  "the first stage's cache does not hold the image prefix")
            clock = "overlap" if overlap else "phased"
            log(pipeline_line(f"{cfg.name}, {ch}, {clock} clock, batch {B}, "
                              f"prompts of {S} after {cfg.frontend_tokens} image "
                              f"embeddings, {new} new", res, wall, stage, card))
            runs[overlap] = res
            summary[f"{ch}_{clock}"] = dict(
                wall_s=wall, stage_compute_s=stage, makespan_s=res.makespan,
                cost_usd=res.cost.total, raw_bytes=res.raw_exchange_bytes)
        a, b = runs[True], runs[False]
        for f in ("P", "memory_mb", "publish_units", "bytes_sns_to_sqs",
                  "sqs_api_calls", "s3_puts", "s3_gets", "s3_lists"):
            check(getattr(a.stats, f) == getattr(b.stats, f), f"{ch}: {f}")
        check(a.raw_exchange_bytes == b.raw_exchange_bytes
              and a.makespan <= b.makespan + 1e-12, f"{ch}: clocks differ")
    log(f"[pipeline] {cfg.name}: every run bit for bit the device engine's, "
        f"{cfg.n_layers} x {new} decode kernels a run, every billed count equal "
        f"between the clocks; stages of {[ex.spec.n_layers for ex in executors]}"
        f" layers, the embeddings on stage 0")
    del executors
    return cfg.n_layers * new, summary


def family_phase(dev, peaks, card, arch):
    """One of phases 10-12 (``FAMILY_PHASES[arch]``): the model at full
    width (bf16 params drawn on the card from seed 0, ``torch-splitk``),
    ``generate`` for 8 prompts (and frontend inputs) with 32 new tokens and
    its launches, times, peak memory and profile; the decode kernel at the
    path's shapes; the bf16 teacher-forced gate; a graphed stream; for vlm
    the pipeline; fp32 at full depth, torch-splitk against dense-ref on the
    card; and an fp32 depth cut at full width, the card against the CPU.
    Returns (the decode kernel's launches in ``generate``, the numbers,
    its max error)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.serving.engine import ServingEngine, extra_tensors

    spec = FAMILY_PHASES[arch]
    cfg = get_config(arch)
    tag = f"[{cfg.family}]"
    t = time.time()
    engine = ServingEngine(cfg, seed=SEED)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in engine.params.parameters())
    p_bytes = sum(p.numel() * p.element_size() for p in engine.params.parameters())
    log(f"{tag} {cfg.name}: {cfg.n_layers} layers"
        + (f" (+{cfg.n_encoder_layers} encoder)" if cfg.n_encoder_layers else "")
        + f", d_model {cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} KV "
        f"heads, d_head {cfg.d_head}, d_ff {cfg.d_ff}"
        + (f", {cfg.ssm_heads} SSM heads of {cfg.ssm_head_dim}, state "
           f"{cfg.ssm_state}, shared attention every {cfg.shared_attn_every} "
           f"({launches_a_step(cfg)} sites)" if cfg.family == "hybrid" else "")
        + (f", {cfg.frontend_tokens} frontend rows" if cfg.frontend_tokens else "")
        + f"; {n_params / 1e9:.3f} B params ({p_bytes / 1e9:.2f} GB) drawn on "
        f"the card from seed {SEED} in {time.time() - t:.1f} s; backend "
        f"{engine.attn_backend.name}")
    S = spec["prompt"]
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(SERVE_BATCH, S)).astype(np.int32)
    extra = frontend(cfg, SERVE_BATCH, SEED + 1)
    engine.generate(prompts[:, :16], max_new_tokens=2, extra=extra)  # warm-up
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = engine.generate(prompts, max_new_tokens=NEW, extra=extra)
    t_first = time.perf_counter() - t
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    per_step = launches_a_step(cfg)
    want = only(launches, decode_attention=per_step * NEW)
    check(launches == want, f"{cfg.name} serving launches {launches}, want {want}")
    V = cfg.padded_vocab()
    check(res.tokens.shape == (SERVE_BATCH, NEW)
          and bool(((res.tokens >= 0) & (res.tokens < V)).all()),
          f"tokens {res.tokens.shape} out of range")
    check(bool(np.isfinite(res.prefill_logits).all()), "logits not finite")
    log(f"{tag} generate(B {SERVE_BATCH}, prompt {S}, {NEW} new): {t_first:.3f} "
        f"s host wall (first timed run); decode kernel launches "
        f"{launches['decode_attention']} = {per_step} x {NEW}; peak device "
        f"memory {peak / 1e9:.2f} GB; first tokens {res.tokens[0, :8].tolist()}")

    def wall(n_new, reps=2):
        ts = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine.generate(prompts, max_new_tokens=n_new, extra=extra)
            ts.append(time.perf_counter() - t0)
        return statistics.median(ts)

    t_prefill, t_gen = wall(0), wall(NEW)
    step = (t_gen - t_prefill) / NEW
    log(f"{tag} {cfg.name} prefill {t_prefill * 1e3:.2f} ms (median of 2 "
        f"generate(..., 0)); generate {t_gen * 1e3:.2f} ms (median of 2); decode "
        f"{step * 1e3:.3f} ms/step, {SERVE_BATCH / step:.1f} tokens/s; end to "
        f"end {SERVE_BATCH * NEW / t_gen:.1f} tokens/s, on {card}")
    prof = profile_decode(engine, prompts, step * 1e3, extra=extra)

    # the decode kernel at the path's shapes
    need = S + NEW + (cfg.frontend_tokens or 0)
    cap = engine.cache_layout(need).padded_len(need)
    kv = (cfg.eff_heads, cfg.eff_kv_heads, cfg.d_head)
    self_len = S + NEW + (cfg.frontend_tokens if cfg.family == "vlm" else 0)
    shapes = {f"{cfg.name} self": ((SERVE_BATCH, *kv[:2], cap, kv[2]), self_len)}
    if cfg.family == "encdec":
        src = cfg.frontend_tokens
        src_cap = engine.cache_layout(need).padded_len(src)
        shapes[f"{cfg.name} cross"] = ((SERVE_BATCH, *kv[:2], src_cap, kv[2]), src)
    timing, worst = {}, 0.0
    for name, ((B, H, KV, Sk, D), L) in shapes.items():
        timed = spec["timed"].get(name.split()[-1], ())
        t_k, err = path_kernel(dev, peaks, card, name, (B, H, KV, Sk, D), L,
                               (torch.bfloat16, torch.float32), timed)
        worst = max(worst, err)
        if t_k:
            timing[name.split()[-1]] = t_k

    batch = {"tokens": torch.as_tensor(prompts, dtype=torch.int64, device=dev),
             **extra_tensors(extra, dev)}
    forced = teacher_forced(engine, batch, res, need, card,
                            logit_gate=spec["logit_gate"])
    stream = family_stream(engine, dev, card)
    pipe = None
    if "pipeline" in spec:
        pipe = vlm_pipeline(engine, prompts, extra["extra_embeds"], card)

    # fp32 at full depth on the card: the kernel against dense-ref
    p32 = type(engine.params)(cfg, dtype=torch.float32, device=dev)
    for dst, src in zip(p32.parameters(), engine.params.parameters()):
        dst.copy_(src)
    del engine
    torch.cuda.empty_cache()
    outs = {name: ServingEngine(cfg, params=p32, attn_backend=name).generate(
        prompts, max_new_tokens=NEW_FP32, extra=extra)
        for name in ("torch-splitk", "dense-ref")}
    a, b = outs["torch-splitk"], outs["dense-ref"]
    check(np.array_equal(a.tokens, b.tokens),
          f"{cfg.name} fp32 tokens differ: {a.tokens} vs {b.tokens}")
    err_full = float(np.abs(a.prefill_logits - b.prefill_logits).max())
    np.testing.assert_allclose(a.prefill_logits, b.prefill_logits, **E2E_TOL)
    log(f"{tag} {cfg.name} fp32 params at full depth ({n_params * 4 / 1e9:.2f} "
        f"GB), B {SERVE_BATCH}, prompt {S}, {NEW_FP32} new: torch-splitk and "
        f"dense-ref tokens identical; last-step max |logits diff| "
        f"{err_full:.3e} (tolerance 1e-4)")

    # fp32 cut in depth at full width: the card against the CPU
    cut = dataclasses.replace(cfg, **spec["cut"])
    cut_card = type(p32)(cut, dtype=torch.float32, device=dev)
    for name, dst in cut_card.named_parameters():
        dst.copy_(p32.get_parameter(name))
    del p32, outs
    torch.cuda.empty_cache()
    cut_cpu = type(cut_card)(cut, dtype=torch.float32, device="cpu")
    for dst, src in zip(cut_cpu.parameters(), cut_card.parameters()):
        dst.copy_(src.cpu())
    Bc, Sc, newc = FAMILY_CPU
    short = prompts[:Bc, :Sc]
    ex_c = extra and {k: v[:Bc] for k, v in extra.items()}
    memory = {}
    if cfg.family == "encdec":
        from repro_torch.models import encdec

        encode = encdec.encode

        def recorded(params, frames, c):
            memory["card"] = encode(params, frames, c)
            return memory["card"]

        encdec.encode = recorded
    try:
        t = time.time()
        a = ServingEngine(cut, params=cut_card).generate(
            short, max_new_tokens=newc, extra=ex_c)
        t_card = time.time() - t
    finally:
        if memory:
            encdec.encode = encode
    t = time.time()
    b = ServingEngine(cut, params=cut_cpu, device="cpu").generate(
        short, max_new_tokens=newc, extra=ex_c)
    t_cpu = time.time() - t
    check(np.array_equal(a.tokens, b.tokens),
          f"{cfg.name} fp32 cut: card tokens {a.tokens} vs cpu {b.tokens}")
    err_cut = float(np.abs(a.prefill_logits - b.prefill_logits).max())
    note = ""
    if memory:
        # The encoder rounds its activations to bf16, as the reference's
        # does, and the card sums in another order than the CPU: a rounding
        # that flips moves a logit past 1e-4.  So the CPU also decodes from
        # the card's encoder output (the encoder pinned), held to 1e-4;
        # the encoders' own outputs are compared, and the unpinned logits
        # reported.
        cpu_mem = encode(cut_cpu, torch.from_numpy(ex_c["frames"]), cut)
        card_mem = memory["card"].float().cpu()
        same = (cpu_mem.float() == card_mem).float().mean().item()
        mem_err = (cpu_mem.float() - card_mem).abs().max().item()
        encdec.encode = lambda params, frames, c: memory["card"].to(frames.device)
        try:
            b = ServingEngine(cut, params=cut_cpu, device="cpu").generate(
                short, max_new_tokens=newc, extra=ex_c)
        finally:
            encdec.encode = encode
        check(np.array_equal(a.tokens, b.tokens),
              f"{cfg.name} fp32 cut, encoder pinned: card tokens {a.tokens} "
              f"vs cpu {b.tokens}")
        note = (f"; encoder outputs (bf16) card vs CPU: {same:.4%} equal, max "
                f"|diff| {mem_err:.3e}; unpinned last-step max |logits diff| "
                f"{err_cut:.3e} (reported); with the CPU decoding from the "
                f"card's encoder output")
        err_cut = float(np.abs(a.prefill_logits - b.prefill_logits).max())
    np.testing.assert_allclose(a.prefill_logits, b.prefill_logits, **E2E_TOL)
    log(f"{tag} {cfg.name} fp32 params cut to {spec['cut']} (a depth cut, the "
        f"widths full), B {Bc}, prompt {Sc}, {newc} new tokens: card and CPU "
        f"tokens identical {a.tokens.tolist()}{note}; last-step max |logits "
        f"diff| {err_cut:.3e} (tolerance 1e-4; logits std "
        f"{float(b.prefill_logits.std()):.3f}); card {t_card:.1f} s, CPU "
        f"{t_cpu:.1f} s host wall")
    del cut_card, cut_cpu
    torch.cuda.empty_cache()
    summary = dict(prefill_ms=t_prefill * 1e3, step_ms=step * 1e3,
                   tokens_per_s=SERVE_BATCH / step, peak_gb=peak / 1e9,
                   profile=prof, teacher_forced=forced, stream=stream,
                   fp32_full_err=err_full, fp32_cut_err=err_cut)
    if pipe is not None:
        summary["pipeline_launches"], summary["pipeline"] = pipe
    return launches["decode_attention"], timing, summary, worst


# ---------------------------------------------------------------------------
# 13. run_fsi over the sharded fleet backend
# ---------------------------------------------------------------------------


def sharded_phase(dev, card, fsi) -> dict:
    """``run_fsi`` over ``torch-bsr-sharded`` (``SHARDED_RUNS``) on phase
    3's net, inputs and partition: each output bit for bit phase 3's
    ``torch-bsr`` output on the same channel and within 1e-4 of
    ``dense_inference``; FLOPs, messages and raw exchange bytes exactly
    ``numpy-fast``'s, cost within 5%; the launches of each run counted from
    0 (fused: one fleet launch a device block a layer; vmap: one per-worker
    launch a worker a layer).  Returns, by run, its launches and host
    wall."""
    from repro_torch.core.backends import TorchBsrShardedBackend
    from repro_torch.faas.simulator import run_fsi

    out = {}
    for ch, d, dispatch in SHARDED_RUNS:
        plain_out, want, t_plain = fsi["runs"][ch]
        mesh = [dev] * d
        p_pad = -(-P // d) * d
        want_counts = ({"bsr_spmm_fleet": d * LAYERS} if dispatch == "fused"
                       else {"bsr_spmm_fused": p_pad * LAYERS})
        reset_counts()
        t = time.time()
        got = run_fsi(fsi["net"], fsi["x0"], P=P, channel=ch,
                      partition=fsi["partition"], mesh=mesh,
                      compute_backend=TorchBsrShardedBackend(dispatch=dispatch))
        wall = time.time() - t
        counts = read_counts()
        tag = f"{ch} D={d} {dispatch}"
        check(np.array_equal(got.output, plain_out),
              f"sharded {tag}: output differs from torch-bsr's")
        err = float(np.abs(got.output - fsi["dense"]).max())
        np.testing.assert_allclose(got.output, fsi["dense"], **E2E_TOL)
        for key in ("flops_total", "messages"):
            check(got.metrics.get(key) == want.metrics.get(key),
                  f"sharded {tag}: {key}")
        check(got.raw_exchange_bytes == want.raw_exchange_bytes,
              f"sharded {tag}: raw exchange bytes")
        rel_cost = abs(got.cost.total - want.cost.total) / want.cost.total
        check(rel_cost <= 0.05, f"sharded {tag}: cost differs by {rel_cost:.3%}")
        check(counts == only(counts, **want_counts),
              f"sharded {tag}: launches {counts}, expected {want_counts}")
        log(f"[run_fsi] sharded {tag} (P {P} padded to {p_pad}): "
            f"{wall:.2f} s host wall, torch-bsr {t_plain:.2f} s on the same "
            f"channel; output bit for bit torch-bsr's, max |out - "
            f"dense_inference| {err:.3e}; flops, messages, raw bytes equal to "
            f"numpy-fast's, cost {got.cost.total:.6e} vs "
            f"{want.cost.total:.6e}; launches {only(counts, **want_counts)} "
            f"on {card}")
        out[tag] = dict(launches=want_counts, wall_s=wall,
                        torch_bsr_wall_s=t_plain)
    return out


# ---------------------------------------------------------------------------
# 14. training internlm2-1.8b through Trainer.fit
# ---------------------------------------------------------------------------


def timed_trainer(cls):
    """A subclass of the trainer ``cls`` whose train step is timed between
    CUDA events (``step_ms``), and profiled by ``torch.profiler`` at step
    index ``profile_step`` (``profile``: device ms, kernels, wall ms)."""
    class Timed(cls):
        profile_step = None

        def _build_step(self):
            from torch.profiler import ProfilerActivity, profile

            super()._build_step()
            inner = self.train_step
            self.step_ms, self.profile = [], None

            def step(*args):
                self.held = args  # (params, opt_state, batch): phase 17
                if len(self.step_ms) == self.profile_step:
                    torch.cuda.synchronize()
                    with profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA]) as prof:
                        t = time.perf_counter()
                        result = inner(*args)
                        torch.cuda.synchronize()
                        wall = (time.perf_counter() - t) * 1e3
                    rows = device_rows(prof)
                    self.profile = dict(
                        device_ms=sum(us for _, us, _ in rows) / 1e3,
                        kernels=sum(n for _, _, n in rows), wall_ms=wall,
                        top=rows[:8])
                    self.step_ms.append(None)
                    return result
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                result = inner(*args)
                e1.record()
                e1.synchronize()
                self.step_ms.append(e0.elapsed_time(e1))
                return result

            self.train_step = step
    return Timed


def train_bound(cfg, tokens: int, peaks):
    """The least time of one training step (forward, the recomputed forward
    under remat, backward) of ``cfg`` on ``tokens`` tokens: each weight
    product 2 FLOPs a weight a token a pass; the two forward passes in bf16
    at the tensor-core peak, the backward's two products a weight in fp32
    outside the tensor cores (the port differentiates as the reference's
    ``dot_general`` transposes: fp32 cotangents against widened weights,
    with TF32 off).  Attention, norms, the loss and the optimizer left out.
    Returns (ms, matmul weights)."""
    d, V = cfg.d_model, cfg.padded_vocab()
    per_layer = cfg._attn_params() + cfg._dense_ffn_params()
    weights = cfg.n_layers * per_layer + V * d       # the unembedding too
    fwd = 2.0 * weights * tokens
    return (2 * fwd / peaks[2] + 2 * fwd / peaks[1]) * 1e3, weights


def train_bf16_check(dev, cut) -> None:
    """Phase 14 (b) in bf16: the loss and every gradient leaf of the
    ``cut`` model on the card, whose bf16 products are differentiated by
    ``layers._ProductAcc``, against the CPU's, where autograd differentiates
    the widened operands: the same semantics (each cotangent product in
    fp32, rounded once to its operand's dtype) in another summation order.
    Then a control whose backward transposes the cotangent of every square
    weight (wq and wo at d_model 2048), which the gradient gate must
    refuse."""
    import copy

    from repro_torch.models import layers
    from repro_torch.models.registry import get_model
    from repro_torch.training.train_state import value_and_grad

    B, S = TRAIN_CPU
    api = get_model(cut, attn_backend="dense-ref")
    model_cpu = api.init(torch.Generator().manual_seed(SEED))
    model_dev = copy.deepcopy(model_cpu).to(dev)
    model_cpu.requires_grad_(True)
    model_dev.requires_grad_(True)
    check({p.dtype for p in model_dev.parameters()} == {torch.bfloat16},
          "the bf16 check's params are not all bf16")
    tok = np.random.default_rng(SEED).integers(
        0, cut.vocab_size, size=(B, S)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(tok)}
    batch_dev = {k: v.to(dev) for k, v in batch.items()}
    t = time.time()
    loss_c, g_c = value_and_grad(api.loss_fn, model_cpu, batch,
                                 api.ref_leaves(model_cpu))
    t_cpu = time.time() - t

    def card():
        return value_and_grad(api.loss_fn, model_dev, batch_dev,
                              api.ref_leaves(model_dev))

    def leaf_errs(g):
        out = {}
        for key, leaf in g_c.items():
            want = leaf.stacked().float()
            got = g[key].stacked().float().cpu()
            out[key] = float((got - want).abs().max()) / max(
                float(want.abs().max()), 1e-30)
        return out

    loss_d, g_d = card()
    check(all(leaf.stacked().dtype == torch.bfloat16 for leaf in g_d.values()),
          "a bf16 parameter's gradient on the card is not bf16")
    rel_loss = abs(float(loss_d) / float(loss_c) - 1)
    check(rel_loss <= TRAIN_BF16_LOSS_REL, f"bf16 loss card {float(loss_d)} "
          f"vs cpu {float(loss_c)}: {rel_loss:.3e}")
    errs = leaf_errs(g_d)
    for key, err in errs.items():
        check(err <= TRAIN_BF16_GRAD_REL, f"bf16 gradient {key}: {err:.3e} "
              f"of its largest magnitude")
    worst = max(errs, key=errs.get)

    right = layers._ProductAcc

    class Transposed(right):
        @staticmethod
        def backward(ctx, g):
            gx, gw = right.backward(ctx, g)
            if gw is not None and gw.shape[-1] == gw.shape[-2]:
                gw = gw.transpose(-1, -2)
            return gx, gw

    layers._ProductAcc = Transposed
    try:
        _, g_x = card()
    finally:
        layers._ProductAcc = right
    ctrl = leaf_errs(g_x)
    refused = sorted(k for k, e in ctrl.items() if e > TRAIN_BF16_GRAD_REL)
    check(refused, "the bf16 gradient gate does not refuse the control")
    log(f"[train] bf16 {cut.n_layers}-layer cut at full width, batch {B} x "
        f"{S}: loss card {float(loss_d):.7f} vs cpu {float(loss_c):.7f} "
        f"({rel_loss:.3e} relative, tolerance {TRAIN_BF16_LOSS_REL:.3e}); "
        f"every gradient leaf bf16 and within {errs[worst]:.3e} of its "
        f"largest magnitude (tolerance {TRAIN_BF16_GRAD_REL}; the worst "
        f"{'/'.join(worst)}); the control with square weights' cotangents "
        f"transposed: {', '.join('/'.join(k) + f' {ctrl[k]:.3e}' for k in refused)}"
        f" refused; the CPU's forward and backward {t_cpu:.1f} s")
    del model_cpu, model_dev, g_c, g_d, g_x
    torch.cuda.empty_cache()


def train_phase(dev, peaks, card, ckpt_dir: str) -> tuple:
    """Phase 14: internlm2-1.8b at full width through ``Trainer.fit``
    (AdamW, remat on): (a) bf16, full depth, ``TRAIN_FULL_STEPS`` steps of
    ``TRAIN_BATCH`` x ``TRAIN_SEQ`` tokens, timed, profiled, peak memory;
    (b) at a ``TRAIN_CUT``-layer cut, the card against the CPU: in fp32 the
    loss, every gradient leaf, and AdamW's update given the CPU's
    gradients, in bf16 the loss and every gradient leaf
    (:func:`train_bf16_check`); (c) restart at the cut in bf16 under
    deterministic algorithms, bit for bit an uninterrupted run, its
    checkpoints written to ``ckpt_dir`` (phase 18 restores them).  Returns
    the bytes (a)'s step held (params, AdamW state, batch; summed from
    those tensors) and its median step ms."""
    import copy
    import dataclasses

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.models.registry import get_model
    from repro_torch.training import optimizer as opt_mod
    from repro_torch.training.trainer import Trainer, TrainerConfig
    from repro_torch.training.train_state import value_and_grad

    # the derivative of a bf16 product with an fp32 output (``mm.dtype``),
    # which the port does not rely on (``layers._ProductAcc``)
    a = torch.randn(64, 64, device=dev, dtype=torch.bfloat16,
                    requires_grad=True)
    b = torch.randn(64, 64, device=dev, dtype=torch.bfloat16)
    try:
        torch.mm(a, b, out_dtype=torch.float32).sum().backward()
        log(f"[train] torch {torch.__version__}: mm(bf16, out_dtype=fp32) "
            f"has a derivative; its input gradient is {a.grad.dtype}")
    except (RuntimeError, NotImplementedError) as e:
        log(f"[train] torch {torch.__version__}: mm(bf16, out_dtype=fp32) has "
            f"no derivative: {type(e).__name__}: "
            f"{str(e).splitlines()[0][:200]}")
    del a, b

    cfg = get_config(ARCH)
    shape = ShapeConfig("train", seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                        kind="train")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    bound_ms, weights = train_bound(cfg, tokens, peaks)
    log(f"[config] training {ARCH}: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, vocab {cfg.vocab_size} (padded {cfg.padded_vocab()}), "
        f"{cfg.param_count() / 1e9:.3f} B params ({weights / 1e9:.3f} B in "
        f"weight products), bf16 params, AdamW, remat {cfg.remat}; batch "
        f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens from the step-keyed pipeline, "
        f"seed {SEED}")

    # ---- (a) bf16, full depth ----
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tr = timed_trainer(Trainer)(cfg, shape, TrainerConfig(
        total_steps=TRAIN_FULL_STEPS, ckpt_dir=None), seed=SEED, device=dev)
    tr.profile_step = TRAIN_PROFILE_STEP
    t = time.time()
    hist = tr.fit()
    wall = time.time() - t
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses = hist["loss"]
    check(len(losses) == TRAIN_FULL_STEPS and all(map(math.isfinite, losses)),
          f"training losses {losses}")
    check(max(losses[1:]) < losses[0],
          f"training losses {losses} do not all fall below the first")
    # a random init's expected first loss: ln(padded vocab) plus half the
    # logits' variance, (0.02 * sqrt(d_model))^2 for unit-RMS states against
    # N(0, 0.02^2) unembedding rows
    expected = math.log(cfg.padded_vocab()) + 0.5 * (0.02 ** 2) * cfg.d_model
    rel = abs(losses[0] / expected - 1)
    check(rel <= FIRST_LOSS_REL,
          f"first loss {losses[0]} is {rel:.2%} from the init's {expected:.4f}")
    timed = [ms for ms in tr.step_ms[1:] if ms is not None]
    step_ms = statistics.median(timed)
    prof = tr.profile
    busy = None if prof is None or prof["device_ms"] <= 0 else \
        prof["device_ms"] / step_ms
    log(f"[train] {ARCH} bf16 full depth, {TRAIN_FULL_STEPS} steps through "
        f"Trainer.fit: losses {[round(x, 4) for x in losses]} (first "
        f"{losses[0] / math.log(cfg.vocab_size) - 1:+.2%} from ln("
        f"{cfg.vocab_size}) = {math.log(cfg.vocab_size):.4f}, {rel:.2%} from "
        f"the random init's {expected:.4f}); step ms {[fmt_ms(x) for x in tr.step_ms]}"
        f" (the first includes the warm-up; the profiled one not timed); "
        f"median of the other {len(timed)} {step_ms:.1f} ms, "
        f"{tokens / step_ms * 1e3:.0f} "
        f"tokens/s; bound {bound_ms:.1f} ms (the weight products: forward "
        f"and recompute in bf16, backward in fp32), {bound_ms / step_ms:.1%} "
        f"of it; peak device memory {peak:.2f} GB; fit wall {wall:.1f} s on "
        f"{card}")
    if busy is None:
        log("[profile] training step: no device time in the profiler's trace:"
            " not measured")
    else:
        log(f"[profile] training step {TRAIN_PROFILE_STEP}: "
            f"{prof['device_ms']:.1f}"
            f" ms device time over {prof['kernels']} kernels, {prof['wall_ms']:.1f}"
            f" ms wall under the profiler; device busy {busy:.1%} of the "
            f"unprofiled {step_ms:.1f} ms step")
        for key, us, n in prof["top"]:
            log(f"  {us / 1e3:9.3f} ms  {n:6d} x  {key[:90]}")
    params, opt_state, batch = tr.held
    held = held_bytes(params, opt_state, batch)
    log(f"[train] held by the step: {held} bytes (params, AdamW's m, v and "
        f"step, the batch {sorted(batch)})")
    del tr, hist, params, opt_state, batch
    torch.cuda.empty_cache()

    # ---- (b) fp32 at a depth cut, the card against the CPU ----
    cut = dataclasses.replace(cfg, n_layers=TRAIN_CUT)
    B, S = TRAIN_CPU
    api_cpu = get_model(cut, attn_backend="dense-ref")
    api_dev = get_model(cut, attn_backend="dense-ref")
    model_cpu = api_cpu.init(torch.Generator().manual_seed(SEED)).float()
    model_dev = copy.deepcopy(model_cpu).to(dev)
    model_cpu.requires_grad_(True)
    model_dev.requires_grad_(True)
    rng = np.random.default_rng(SEED)
    tok = rng.integers(0, cut.vocab_size, size=(B, S)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(tok)}
    t = time.time()
    loss_c, g_c = value_and_grad(api_cpu.loss_fn, model_cpu, batch,
                                 api_cpu.ref_leaves(model_cpu))
    t_cpu = time.time() - t
    loss_d, g_d = value_and_grad(api_dev.loss_fn, model_dev,
                                 {k: v.to(dev) for k, v in batch.items()},
                                 api_dev.ref_leaves(model_dev))
    rel_loss = abs(float(loss_d) / float(loss_c) - 1)
    check(rel_loss <= TRAIN_LOSS_TOL, f"fp32 loss card {float(loss_d)} vs "
          f"cpu {float(loss_c)}: {rel_loss:.3e}")
    worst = 0.0
    for key, leaf in g_c.items():
        want = leaf.stacked()
        got = g_d[key].stacked().cpu()
        err = float((got - want).abs().max()) / max(float(want.abs().max()),
                                                    1e-30)
        check(err <= TRAIN_GRAD_REL, f"fp32 gradient {key}: {err:.3e} of its "
              f"largest magnitude")
        worst = max(worst, err)
    # AdamW one step on each side, given the CPU's gradients
    sched = opt_mod.get_schedule("cosine", 3e-4, 2, TRAIN_STEPS)
    tree_c, tree_d = api_cpu.ref_leaves(model_cpu), api_dev.ref_leaves(model_dev)
    with torch.no_grad():  # the same starting params on both sides
        for key, leaf in tree_c.items():
            tree_d[key].assign(leaf.stacked().to(dev))
    adam = opt_mod.AdamW(sched)
    g_dev = {k: leaf.map(lambda g: g.to(dev)) for k, leaf in g_c.items()}
    adam.update(g_c, adam.init(tree_c), tree_c)
    adam.update(g_dev, adam.init(tree_d), tree_d)
    upd_err = 0.0
    for key, leaf in tree_c.items():
        want = leaf.stacked().detach()
        got = tree_d[key].stacked().detach().cpu()
        torch.testing.assert_close(got, want, **TRAIN_UPDATE_TOL)
        upd_err = max(upd_err, float((got - want).abs().max()))
    log(f"[train] fp32 {TRAIN_CUT}-layer cut at full width, batch {B} x {S}: "
        f"loss card {float(loss_d):.7f} vs cpu {float(loss_c):.7f} "
        f"({rel_loss:.3e} relative, tolerance {TRAIN_LOSS_TOL}); every "
        f"gradient leaf within {worst:.3e} of its largest magnitude "
        f"(tolerance {TRAIN_GRAD_REL}); AdamW's update given the CPU's "
        f"gradients max |card - cpu| {upd_err:.3e} (tolerance 1e-6); the "
        f"CPU's forward and backward {t_cpu:.1f} s")
    del model_cpu, model_dev, g_c, g_d, g_dev, tree_c, tree_d
    torch.cuda.empty_cache()
    train_bf16_check(dev, cut)

    # ---- (c) restart at the cut, bf16, bit for bit ----
    cut_shape = ShapeConfig("train", seq_len=TRAIN_SEQ,
                            global_batch=TRAIN_BATCH, kind="train")
    torch.use_deterministic_algorithms(True)
    try:
        def trainer(**kw):
            return Trainer(cut, cut_shape, TrainerConfig(
                total_steps=TRAIN_STEPS, ckpt_every=2, **kw), seed=SEED,
                device=dev)
        full = trainer()
        h_full = full.fit()
        t = time.time()
        trainer(ckpt_dir=ckpt_dir, stop_after=2).fit()
        resumed = trainer(ckpt_dir=ckpt_dir)
        h_res = resumed.fit(resume=True)
        t_ckpt = time.time() - t
        on_disk = sum(f.stat().st_size for f in Path(ckpt_dir).rglob("*.npy"))
        free = shutil.disk_usage(ckpt_dir).free
    except RuntimeError as e:
        log(f"[train] restart check: an op raised under deterministic "
            f"algorithms: {str(e).splitlines()[0]}")
        raise
    finally:
        torch.use_deterministic_algorithms(False)
    check(h_res["step"] == [2, 3], f"resumed steps {h_res['step']}")
    check(h_res["loss"] == h_full["loss"][2:],
          f"resumed losses {h_res['loss']} vs {h_full['loss'][2:]}")
    a = dict(full.params.named_parameters())
    b = dict(resumed.params.named_parameters())
    for name in a:
        check(torch.equal(a[name], b[name]), f"restart: {name} differs")
    for moment in ("m", "v"):
        for key, leaf in full.opt_state[moment].items():
            check(torch.equal(leaf.stacked(),
                              resumed.opt_state[moment][key].stacked()),
                  f"restart: AdamW {moment} of {key} differs")
    check(int(full.opt_state["step"]) == int(resumed.opt_state["step"])
          == TRAIN_STEPS, f"restart: AdamW step {int(full.opt_state['step'])} "
          f"vs {int(resumed.opt_state['step'])}")
    log(f"[train] restart, bf16 {TRAIN_CUT}-layer cut, batch {TRAIN_BATCH} x "
        f"{TRAIN_SEQ}, deterministic algorithms: {TRAIN_STEPS} steps "
        f"uninterrupted == stop after 2 + resume to {TRAIN_STEPS}, params, "
        f"AdamW's m, v and step ({TRAIN_STEPS}) and losses {h_res['loss']} "
        f"bit for bit; the crashed "
        f"and resumed runs with their checkpoints {t_ckpt:.1f} s "
        f"({on_disk / 1e9:.2f} GB of .npy in two steps, kept for phase 18; "
        f"{free / 1e9:.0f} GB were free beside them)")
    del full, resumed
    torch.cuda.empty_cache()
    return held, step_ms


def held_bytes(params, opt_state, batch) -> int:
    """Bytes of a training step's arguments, summed from the tensors: the
    model's parameters, AdamW's ``m``, ``v`` and ``step``, the batch."""
    n = sum(p.numel() * p.element_size() for p in params.parameters())
    n += sum(p.numel() * p.element_size() for key in ("m", "v")
             for leaf in opt_state[key].values() for p in leaf.parts)
    n += opt_state["step"].numel() * opt_state["step"].element_size()
    return n + sum(t.numel() * t.element_size() for t in batch.values())


def dryrun_phase(card, train_held: int, train_ms: float, decode_ms: float
                 ) -> None:
    """Phase 17: the meta-device dry run (``launch/dryrun.py``) priced
    with this card's constants: the reference's two gate cells on the
    production mesh, phase 14's training step and phase 5's decode step
    on a ``(1, 1)`` mesh beside their measured times, the route of the
    example's archs; nothing allocated on the card."""
    from repro_torch.configs import ShapeConfig, get_config, get_shape
    from repro_torch.core.cost_model import accelerator_for
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh, make_production_mesh
    from repro_torch.serving.router import route_accelerator

    t0 = time.time()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    kind, consts = accelerator_for(torch.cuda.get_device_name(0))
    total = torch.cuda.get_device_properties(0).total_memory
    rel = abs(consts.hbm_bytes / total - 1)
    check(rel <= DRYRUN_HBM_REL, f"the {kind}'s hbm_bytes {consts.hbm_bytes} "
          f"vs the card's total memory {total}: {rel:.3%}")
    log(f"[dryrun] constants of the {kind}: {consts.peak_bf16_flops / 1e12} "
        f"TFLOP/s bf16, {consts.hbm_bandwidth / 1e12} TB/s HBM, "
        f"{consts.link_bandwidth / 1e9} GB/s NVLink a direction, hbm_bytes "
        f"{consts.hbm_bytes} ({rel:.3%} from the card's total memory {total})")

    def terms(r) -> str:
        return (f"compute {r.compute_term_s * 1e3:.3f} ms, memory "
                f"{r.memory_term_s * 1e3:.3f} ms, collective "
                f"{r.collective_term_s * 1e3:.3f} ms -> {r.bottleneck}; "
                f"FLOPs/dev {r.flops_per_device:.4e} (products "
                f"{r.product_flops_per_device:.4e}), args/dev "
                f"{r.argument_bytes:.0f} B, temp/dev ~{r.temp_bytes:.4e} B, "
                f"collectives/dev {r.collective_bytes}; the meta step "
                f"{r.compile_s:.1f} s")

    prod = make_production_mesh()
    for arch, shape in DRYRUN_CELLS:
        r = dryrun.run_cell(arch, shape, mesh=prod, verbose=False,
                            constants=consts)
        check(r.status == "ok", f"dry run {arch} x {shape}: {r.note}")
        log(f"[dryrun] {arch} x {shape} on the 16x16 meta mesh: {terms(r)}")

    one = make_mesh((1, 1), ("data", "model"), ["meta"])
    train = ShapeConfig("train_card", seq_len=TRAIN_SEQ,
                        global_batch=TRAIN_BATCH, kind="train")
    r = dryrun.run_cell(ARCH, train, mesh=one, verbose=False, constants=consts)
    check(r.status == "ok", f"dry run of phase 14's step: {r.note}")
    check(r.argument_bytes == train_held, f"dry run argument bytes "
          f"{r.argument_bytes} vs {train_held} held by phase 14's step")
    log(f"[dryrun] {ARCH} training step {TRAIN_BATCH} x {TRAIN_SEQ} on 1x1: "
        f"argument bytes {r.argument_bytes:.0f} == phase 14's held bytes; "
        f"{terms(r)}; measured {train_ms:.1f} ms a step (phase 14): compute "
        f"term {r.compute_term_s * 1e3 / train_ms:.1%} of it, memory term "
        f"{r.memory_term_s * 1e3 / train_ms:.1%}, on {card}")
    dec = ShapeConfig("decode_card", seq_len=DECODE_SHAPE[3],
                      global_batch=SERVE_BATCH, kind="decode")
    r = dryrun.run_cell(ARCH, dec, mesh=one, verbose=False, constants=consts)
    check(r.status == "ok", f"dry run of phase 5's decode step: {r.note}")
    log(f"[dryrun] {ARCH} decode step B {SERVE_BATCH}, cache "
        f"{DECODE_SHAPE[3]} on 1x1: {terms(r)}; measured {decode_ms:.3f} ms "
        f"a step (phase 5): memory term {r.memory_term_s * 1e3 / decode_ms:.1%}"
        f" of it, compute term {r.compute_term_s * 1e3 / decode_ms:.1%}, on "
        f"{card}")
    for arch in DRYRUN_ROUTE_ARCHS:
        route = route_accelerator(get_config(arch), get_shape("decode_32k"),
                                  constants=consts)
        log(f"[dryrun] route {arch} x decode_32k: {route.chips} {kind} "
            f"cards ({route.reason})")
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    check(after == before, f"the dry run allocated on the card: {before} -> "
          f"{after} bytes")
    wall = time.time() - t0
    check(wall <= DRYRUN_MAX_S, f"phase 17 took {wall:.1f} s")


# ---------------------------------------------------------------------------
# 18. real tensors on placements
# ---------------------------------------------------------------------------


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal dtypes, shapes and bits (-0.0 is not 0.0, a NaN equals its
    own bits)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        as_int = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
        a, b = (t.view(as_int[t.element_size()]) for t in (a, b))
    return torch.equal(a, b.to(a.device))


def placement_phase(dev, card, ckpt_dir: str) -> None:
    """Phase 18: phase 14 (c)'s checkpoint restored onto the reference's
    ``(2, 4)`` mesh of the card and of the CPU, a sharded batch, and
    ``compressed_psum`` over ``[cuda:0] * PSUM_SHARDS`` (the module
    docstring's item 18)."""
    import dataclasses

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.data.pipeline import PipelineSpec
    from repro_torch.distributed.compression import (Int8Compressor,
                                                     compressed_psum)
    from repro_torch.distributed.sharding import (batch_pspecs, gather,
                                                  param_pspecs, placements)
    from repro_torch.launch.mesh import MeshAxes, make_mesh
    from repro_torch.models.param_tree import RefLeaf, flatten, nest
    from repro_torch.models.registry import abstract_params, get_model
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training.optimizer import get_optimizer
    from repro_torch.training.train_state import value_and_grad

    t0 = time.time()
    cut = dataclasses.replace(get_config(ARCH), n_layers=TRAIN_CUT)
    api = get_model(cut, attn_backend="dense-ref")
    leaves = api.ref_leaves(abstract_params(cut))     # on meta
    opt = get_optimizer(cut)
    state = opt.init(leaves)
    like = {"params": nest(leaves),
            "opt": {k: nest(v) if isinstance(v, dict) else v
                    for k, v in state.items()}}

    def shardings(mesh):
        specs = param_pspecs(cut, leaves, MeshAxes(mesh))
        return {"params": placements(mesh, specs),
                "opt": placements(mesh, opt.state_pspecs(specs, leaves))}

    def on_cpu(leaf):
        if isinstance(leaf, RefLeaf):
            return RefLeaf(leaf.lead, [torch.empty_like(p, device="cpu")
                                       for p in leaf.parts])
        return torch.empty_like(leaf, device="cpu")

    step = ckpt.latest_steps(ckpt_dir)[-1]
    step_bytes = sum(f.stat().st_size for f in
                     (Path(ckpt_dir) / f"step_{step:08d}").glob("*.npy"))

    # ---- (a) the elastic restore ----
    mesh_dev = make_mesh(*PLACE_MESH, [dev] * 8)
    mesh_cpu = make_mesh(*PLACE_MESH, ["cpu"] * 8)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t = time.time()
    placed, got_step = ckpt.restore(ckpt_dir, like, shardings=shardings(mesh_dev))
    torch.cuda.synchronize()
    restore_s = time.time() - t
    peak = torch.cuda.max_memory_allocated() - base
    t = time.time()
    placed_cpu, _ = ckpt.restore(ckpt_dir, like, shardings=shardings(mesh_cpu))
    cpu_s = time.time() - t
    t = time.time()
    whole, _ = ckpt.restore(
        ckpt_dir, nest({p: on_cpu(x) for p, x in flatten(like).items()}))
    whole_s = time.time() - t
    check(got_step == step, f"restored step {got_step}, latest {step}")
    flat, flat_cpu, flat_whole = flatten(placed), flatten(placed_cpu), \
        flatten(whole)
    copied, n_split = {}, 0
    for path, sharded in flat.items():
        twin = flat_cpu[path]
        check(len(sharded.shards) == len(twin.shards) == 8,
              f"{path}: {len(sharded.shards)} shards")
        back = {}   # each card copy brought to the host once
        for n, (a, b, d) in enumerate(zip(sharded.shards, twin.shards,
                                          mesh_dev.flat())):
            check(a.data.device == d and a.data.is_contiguous(),
                  f"{path} shard {n} on {a.data.device}")
            check(a.index == b.index, f"{path} shard {n}: index {a.index} vs "
                  f"the CPU's {b.index}")
            ptr = a.data.data_ptr()
            if ptr not in back:
                back[ptr] = a.data.cpu()
                copied[ptr] = a.data.numel() * a.data.element_size()
            check(same_bits(b.data, back[ptr]),
                  f"{path} shard {n} differs from the CPU mesh's")
        want = flat_whole[path]
        want = want.stacked() if isinstance(want, RefLeaf) else want
        check(same_bits(gather(sharded, dev), want.to(dev)),
              f"gather of {path} differs from the unsharded restore")
        n_split += sharded.blocks > 1
    check(n_split > 0, "no leaf was split")
    log(f"[placement] {ARCH} {TRAIN_CUT}-layer cut, bf16 params with AdamW's "
        f"m, v and step: checkpoint step {step} ({step_bytes} bytes of .npy) "
        f"restored onto a {PLACE_MESH[0]} {PLACE_MESH[1]} mesh of "
        f"[{mesh_dev.flat()[0]}] x 8 in {restore_s:.2f} s: "
        f"{sum(copied.values())} bytes copied to the card (each block once; "
        f"a replica on the same device shares its copy), peak device memory "
        f"{peak} bytes above the {base} before; onto the CPU mesh "
        f"{cpu_s:.2f} s, unsharded {whole_s:.2f} s; {len(flat)} leaves, "
        f"{n_split} split more than one way; every card shard bit for bit "
        f"the CPU mesh's at the same position, every gather bit for bit the "
        f"unsharded restore, on {card}")
    del placed, placed_cpu, whole, flat, flat_cpu, flat_whole
    torch.cuda.empty_cache()

    # ---- (b) batches ----
    shape = ShapeConfig("train", seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                        kind="train")
    spec = PipelineSpec(cut, shape, seed=SEED)
    host = spec.batch(PLACE_BATCH_STEP)
    batch_sh = placements(mesh_dev, batch_pspecs(cut, shape, host,
                                                 MeshAxes(mesh_dev)))
    t = time.time()
    batch = spec.device_batch(PLACE_BATCH_STEP, device=dev, shardings=batch_sh)
    torch.cuda.synchronize()
    batch_ms = (time.time() - t) * 1e3
    for key, sharded in batch.items():
        for n, (shard, d) in enumerate(zip(sharded.shards, mesh_dev.flat())):
            check(shard.data.device == d and np.array_equal(
                shard.data.cpu().numpy(), host[key][shard.index]),
                f"batch {key} shard {n} is not its slice of batch(step)")
    log(f"[placement] device_batch({PLACE_BATCH_STEP}, shardings=) of "
        f"{TRAIN_BATCH} x {TRAIN_SEQ} on the {PLACE_MESH[0]} mesh: specs "
        f"{ {k: tuple(p.spec) for k, p in batch_sh.items()} }, every shard "
        f"its slice of batch({PLACE_BATCH_STEP}); {batch_ms:.2f} ms host wall "
        f"on {card}")
    del batch

    # ---- (c) compressed_psum ----
    B, S = TRAIN_CPU
    pipe = PipelineSpec(cut, ShapeConfig("train", seq_len=S, global_batch=B,
                                         kind="train"), seed=SEED)
    model = api.init(torch.Generator(device=dev).manual_seed(SEED)).float()
    model.requires_grad_(True)
    grads = []
    for b in range(PSUM_SHARDS):
        _, tree = value_and_grad(api.loss_fn, model,
                                 pipe.device_batch(b, device=dev),
                                 api.ref_leaves(model))
        grads.append({k: leaf.stacked().detach() for k, leaf in tree.items()})
    fp32_bytes, int8_bytes = Int8Compressor.wire_bytes(tree)
    del model, tree
    worst, largest, cpu_psum_s = 0.0, None, 0.0
    for key in grads[0]:
        shards = [g[key] for g in grads]
        got = compressed_psum(shards)
        t = time.time()
        want = compressed_psum([x.cpu() for x in shards])
        cpu_psum_s += time.time() - t
        check(got.device == shards[0].device and same_bits(want, got.cpu()),
              f"compressed_psum of {key} differs from the CPU's")
        scale = max(float(x.abs().max()) for x in shards) / 127.0
        err = float((got - torch.stack(shards).sum(0)).abs().max())
        check(err <= 8 * scale, f"compressed_psum of {key}: {err} from the "
              f"fp32 sum, over 8 x scale {8 * scale}")
        worst = max(worst, err / max(scale, 1e-30))
        if largest is None or shards[0].numel() > largest[1][0].numel():
            largest = (key, shards)
    key, shards = largest
    psum_ms = time_ms(lambda: compressed_psum(shards), reps=5)
    log(f"[placement] compressed_psum over {PSUM_SHARDS} shards on "
        f"[{shards[0].device}] x {PSUM_SHARDS}: the {TRAIN_CUT}-layer cut's fp32 gradient "
        f"leaves from batches 0-{PSUM_SHARDS - 1} ({B} x {S}), {len(grads[0])} "
        f"leaves bit for bit the CPU's on the same shards ({cpu_psum_s:.1f} s "
        f"there), each within {worst:.3f} x its scale of the fp32 sum (limit "
        f"8); the largest leaf {key} {tuple(shards[0].shape)}: "
        f"{psum_ms:.4f} ms a call; wire bytes a reduction int8 {int8_bytes} "
        f"vs fp32 {fp32_bytes} ({int8_bytes / fp32_bytes:.4f}) on {card}")
    del grads, shards, largest
    torch.cuda.empty_cache()
    wall = time.time() - t0
    check(wall <= PLACE_MAX_S, f"phase 18 took {wall:.1f} s")


# ---------------------------------------------------------------------------


def build_all():
    """Start every kernel's ``nvcc`` together; log each build's time and
    what ptxas said of registers and spills."""
    def build(mod):
        t = time.time()
        mod.load_library()
        return time.time() - t

    mods = kernel_modules()
    t = time.time()
    with ThreadPoolExecutor(len(mods) + len(VARIANTS)) as pool:
        variants = [pool.submit(variant, name) for name in VARIANTS]
        took = dict(zip(mods, pool.map(build, mods.values())))
        for done in variants:
            done.result()
    for name, mod in mods.items():
        log(f"[build] {name} -> {mod.library_path().parent.name}: "
            f"{took[name]:.2f} s")
        for line in (mod.library_path().parent / "nvcc.log").read_text().splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")
    log(f"[build] all libraries and the variants {list(VARIANTS)}: "
        f"{time.time() - t:.2f} s")
    from repro_torch.kernels import _build

    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run(
        [str(cuobjdump), "-sass", str(mods["flash_attention.cu"].library_path())],
        capture_output=True, text=True, check=True, timeout=300).stdout
    n_hgmma = sum("HGMMA" in line for line in sass.splitlines())
    log(f"[sass] flash_attention.cu: {n_hgmma} HGMMA instructions (the bf16 "
        f"path's wgmma on tensor cores)")
    check(n_hgmma > 0, "flash_attention.cu has no HGMMA instruction")
    sass = subprocess.run(
        [str(cuobjdump), "-sass", str(mods["ssd_scan.cu"].library_path())],
        capture_output=True, text=True, check=True, timeout=300).stdout
    n_hmma = sum("HMMA" in line for line in sass.splitlines())
    log(f"[sass] ssd_scan.cu: {n_hmma} HMMA instructions (C·B of bf16 inputs, "
        f"mma.sync on tensor cores)")
    check(n_hmma > 0, "ssd_scan.cu has no HMMA instruction")


def sparse_layer_check(dev, card) -> float:
    """``sparse_layer_apply`` (an offline ``BSRMatrix``, padded by
    ``prepare_bsr_operands``, through the hand-written ``bsr_spmm`` kernel:
    one launch) on the card against ``bsr_spmm``'s plain version on the same
    operands, at 1e-5.  Returns the max error."""
    from repro_torch.core.sparse import bsr_from_dense
    from repro_torch.kernels.bsr_spmm import ops, ref

    n, b, density, bias = SPARSE_LAYER
    rng = np.random.default_rng(SEED)
    dense = (rng.standard_normal((n, n)) * (rng.random((n, n)) < density)
             ).astype(np.float32)
    bsr = bsr_from_dense(dense, (32, 32))
    x = np.abs(rng.standard_normal((n, b))).astype(np.float32)
    reset_counts()
    y = ops.sparse_layer_apply(bsr, x, bias)
    counts = read_counts()
    check(counts == only(counts, bsr_spmm_fused=1),
          f"sparse_layer_apply launches {counts}")
    blocks, cols = ops.prepare_bsr_operands(bsr, device=dev)
    want = ref.bsr_spmm_fused_ref(blocks, cols, torch.as_tensor(x, device=dev),
                                  bias)
    torch.testing.assert_close(y, want, **TOL)
    err = (y - want).abs().max().item()
    log(f"[sparse_layer_apply] N {n}, batch {b}, 32x32 blocks "
        f"({blocks.shape[0]} block rows, K {blocks.shape[1]}), bias {bias}: "
        f"one bsr_spmm_fused launch, max_abs_err {err:.3e} against the plain "
        f"version (rtol=atol=1e-5), on {card}")
    return err


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible; the port's smoke run needs one",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.time()

    # ---- 1. card + build -------------------------------------------------
    card = card_line()
    log(card)
    name = card.split(",")[0].strip()
    kind, peaks = peaks_for(name)
    log(f"[card] {name} x{torch.cuda.device_count()}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}; peaks of the {kind} data sheet: "
        f"{peaks[0] / 1e12} TB/s HBM, {peaks[1] / 1e12} TFLOP/s fp32, "
        f"{peaks[2] / 1e12} TFLOP/s bf16")
    build_all()

    timing, launches, errs, fsi = fsi_phases(dev, peaks, card)
    errs["bsr_spmm_fused"] = max(errs["bsr_spmm_fused"],
                                 sparse_layer_check(dev, card))
    t = time.time()
    sharded = sharded_phase(dev, card, fsi)
    del fsi
    for key in ("bsr_spmm_fused", "bsr_spmm_fleet"):
        timing[key]["sharded"] = {
            tag: dict(launches=run["launches"].get(key, 0),
                      wall_s=run["wall_s"],
                      torch_bsr_wall_s=run["torch_bsr_wall_s"])
            for tag, run in sharded.items()}
        launches[key] += sum(run["launches"].get(key, 0)
                             for run in sharded.values())
    log(f"[sharded] phase {time.time() - t:.1f} s")
    timing["decode_attention"], errs["decode_attention"] = decode_phase(
        dev, peaks, card)
    launches["decode_attention"], decode_ms = serve_phase(dev, card)
    stream_launches, row_err, stream = cb_phase(dev, card)
    timing["decode_attention"].update(stream_launches=stream_launches,
                                      stream=stream)
    errs["decode_attention"] = max(errs["decode_attention"], row_err)
    t = time.time()
    mesh_launches, mesh_err, stream_mesh = stream_mesh_phase(dev, card)
    log(f"[stream-mesh] phase 15 {time.time() - t:.1f} s")
    timing["decode_attention"].update(stream_mesh_launches=mesh_launches,
                                      stream_mesh=stream_mesh)
    errs["decode_attention"] = max(errs["decode_attention"], mesh_err)
    (timing["flash_attention"], launches["flash_attention"],
     errs["flash_attention"]) = flash_phase(dev, peaks, card)
    timing["ssd_scan"], launches["ssd_scan"], errs["ssd_scan"] = mamba2_phase(
        dev, peaks, card)
    pipe_launches, pipe = pipeline_phase(dev, card)
    moe_launches, moe_timing, moe, moe_err = moe_phase(dev, peaks, card)
    timing["decode_attention"].update(
        pipeline_launches=pipe_launches, pipeline=pipe,
        moe_generate_launches=moe_launches, moe_decode_shape=moe_timing,
        moe=moe)
    errs["decode_attention"] = max(errs["decode_attention"], moe_err)
    for arch, key in (("zamba2-7b", "hybrid"), ("seamless-m4t-medium", "encdec"),
                      ("internvl2-2b", "vlm")):
        t = time.time()
        n, shapes, summary, err = family_phase(dev, peaks, card, arch)
        log(f"[{key}] phase {time.time() - t:.1f} s")
        timing["decode_attention"].update({
            f"{key}_generate_launches": n, f"{key}_decode_shapes": shapes,
            key: summary})
        errs["decode_attention"] = max(errs["decode_attention"], err)

    with tempfile.TemporaryDirectory() as ckpt_dir:
        t = time.time()
        train_held, train_ms = train_phase(dev, peaks, card, ckpt_dir)
        log(f"[train] phase {time.time() - t:.1f} s")
        t = time.time()
        placement_phase(dev, card, ckpt_dir)
        log(f"[placement] phase 18 {time.time() - t:.1f} s on {card}")

    t = time.time()
    dryrun_phase(card, train_held, train_ms, decode_ms)
    log(f"[dryrun] phase 17 {time.time() - t:.1f} s")

    # ---- 19. kernels line ------------------------------------------------
    kernels = [dict(name=k, route="cuda", source=SOURCES[k],
                    replaces=REPLACES[k], launches=launches[k],
                    max_abs_err=errs[k], **timing[k])
               for k in SOURCES]
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']} was not launched on its path")
    log(f"[total] {time.time() - t_start:.1f} s")
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
