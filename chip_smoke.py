"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero, printing no
result line):

1. build the port's CUDA kernels from the sources in this checkout (nvcc at
   first use) and load them; print ptxas's registers and spill bytes for
   every kernel and the tensor-core instructions (HMMA, HGMMA, IMMA) of
   each kernel from ``cuobjdump -sass``: the bf16 flash attention kernel
   must have HGMMA (wgmma) at every head dim, and so must the bf16
   backward's tensor-core kernels (``attn_bwd_dkdv_wgmma_kernel``,
   ``attn_bwd_dq_wgmma_kernel``) at D 32, 64 and 128, which, like every
   backward kernel, may not spill; the int8 crossbar kernel
   (``crossbar_mxv_int8_kernel``) IMMA (mma.sync s8), the decode kernels
   (``decode_split_kernel``, ``decode_merge_kernel``) must be built, and
   the crossbar kernels, the scan kernel (``scan_lanes_kernel``, at
   every instantiation), the scan backward's three kernels in both
   dtypes and AdamW's four kernels (``csrc/adamw.cu``: the table fill,
   the norm, its finalize, the update; each chunk's types picked at run
   time) built without spills;
2. hold each kernel against its plain PyTorch version on CUDA tensors: the
   main path's shapes, lenet-28's shapes and edge shapes (N in {1, 3, 130},
   M = 1, a full 256x256 crossbar at B = 1024, batch sizes either side of
   a change of ``mxv_plan``'s layout, N of 256 and 300, N of 3000 and 5001
   in several chunks of k, rows not 4-byte aligned, strided x, misaligned
   weights, bf16 x, also at odd N and one element off its alignment), and
   each kernel bit-equal to itself over two launches at every shape.
   Float kernel: allclose at rtol 1e-5 and atol 1e-5 x
   max(1, max|output|) in f32 (both sum f32 products, in different orders,
   so the rounding error scales with the terms), 5e-2 the same way in bf16
   (one bf16 rounding of the output).  Int8 kernel: bit-equal (exact
   integer sum, then the same two f32 multiplies in the same order);
3. main path: ``build_resnet_block_chain(2, c=28, img=16)`` compiled on
   ``make_chip(8, "banded")`` with ``dequantize_int8``, 8 Poisson requests
   served through ``CmServer`` on its default plane (``TorchPlane`` on the
   card), against the same serve on ``NumpyPlane``: outputs within
   rtol 1e-5 / atol 2e-5 + 1e-6 * max|output| (see ``_float_tol``),
   simulator counters and serve reports exactly equal, and one float
   kernel launch per plane call;
4. DAC path: ``build_lenet_like(img=28)`` served on ``TorchPlane(dac=True)``:
   outputs within 5% of scale of the numpy plane, counters equal, int8
   kernel launched;
5. times (CUDA events, median after warm-up) of each kernel, its plain
   version and a library call at the shape its path launched most often,
   beside the least time the card could take (bytes / 3.35 TB/s or
   operations / peak, whichever is larger), with ``mxv_plan``'s grid and
   layout and the wrapper's host time per call
   (``decode_host_cost.host_us_per_call``); both kernels' device time at
   the main path's crossbar at B = 1 and 256; the kernel's device time under
   torch.profiler, and the library call's (``_device_total_us``: per call,
   the union of the intervals of every kernel and copy it launches, or,
   in a profile that dropped events, each kernel's mean duration times its
   launches per call, summed; both printed); the host time of one
   plane call on each plane; the device's busy and idle share over one
   profiled serve (the same union); wall time of each serve, in turns.

6. the attention kernels (flash attention, flash decode, int8-KV flash
   decode) against their plain versions at llama3.2-3b's full-width heads
   (Hq 24, Hkv 8, D 128): S in {1, 17, 128, 512, 2048}, B in {1, 8}, ragged
   per-row lengths with, at B = 8, one row of length 0 (every position
   masked: the mean of V over all S, as the Pallas kernel gives), (B, S,
   H, D) inputs read through strides, f32 and bf16; flash attention also
   non-causal, with Sq < Sk, and causal with 100 queries over 33 keys (the
   67 rows before the first key get the mean of V).  Tolerances of
   ``tests/test_kernels.py``: 2e-3 in f32 and 5e-2 in bf16 (flash
   attention and flash decode; the int8 decode with a bf16 query too),
   2e-5 for the int8 decode against dequantize-then-plain in f32.  In
   bf16, flash attention runs on the tensor cores
   (``flash_attention_wgmma_kernel``: bf16 products, f32 accumulation, P
   rounded to bf16 before the P.V product); in f32 on the CUDA cores.  A
   decode call is two kernels, ``decode_split_kernel`` (partials per chunk
   of 64 positions) and ``decode_merge_kernel``;
7. the LM serve path: llama3.2-3b at full width (28 layers, bf16, seeded
   random weights on the card) through ``ServeEngine.generate`` (B = 8,
   prompts of 512, 32 new tokens) and ``ContinuousBatcher`` (8 slots,
   max_len 2048, 16 requests of 16-1000 prompt tokens, 32 new each), with
   ``kv_dtype`` "compute" and "int8", both replaying their captured decode
   step (``serve.graphs.DecodeGraph``, the engines' default on the card)
   and the batcher its captured bucket prefills (``PrefillGraph``): the
   launch counts are layers x prefills (flash attention) and layers x
   decode steps (the decode kernel of the cache's type; the other one 0),
   a replay adding what its capture launched and the captures' own
   launches kept out.  Phase 20 follows.  Then the kernel path against
   ``use_kernel=False`` on the card: depth cut to 4 layers in f32, prefill
   and decode logits within 2e-3 x max(1, max|logit|) and, with the float
   cache, greedy tokens equal (with the int8 cache the share of equal
   tokens is printed: a rounding difference can flip an int8 code);
   full depth in bf16, logits within ``BF16_LOGIT_BOUND`` x
   max(1, max|logit|) (measured on the card, PERF.md);
8. times: prefill ms and decode tok/s from ``throughput_probe`` in turns
   (graph, eager, eager, graph: the captured decode step against
   ``compile=False``), the plain path's and the int8 cache's (graph); a
   profiled ``generate`` each way (wall ms, device-busy ms, idle share, the
   graph captured before the profile; the profiler records the replayed
   kernels one by one), the same call profiled for device activity only
   (wall and busy from that one call), and the full profile's busy time
   over an unprofiled call's wall, an estimate from two calls; the engine's B = 8 prefill profiled, and a B = 1
   bucket prefill (the batcher's, buckets 16, 128, 512, 1024) eager and
   replayed from a ``PrefillGraph``: wall ms, and over one profiled call
   wall, device busy and idle share, logits bit-equal (the batcher
   captures buckets up to ``PREFILL_GRAPH_MAX_BUCKET``, those whose eager
   idle share was above 0.5); each attention kernel at the shape its path
   launched most often (decode at every row's length in the middle step
   of the generate, ``DECODE_LENGTH``: CUDA events; device time under
   torch.profiler: the
   flash kernel's own, and for a decode call ``_device_total_us`` over its
   split and merge kernels, with each one's own time, and again with the
   cache cold in L2, as a decode step finds it: calls rotating over copies
   of the cache that add up to 1.5 x the L2; the launch plan's grids and
   working blocks as ``decode_plan`` computes them, beside the split
   blocks counted on the card, those that wrote partials into a workspace
   filled with NaN, whose output must equal the call's bit for bit; the
   wrapper's host time per call), its plain version and
   ``F.scaled_dot_product_attention`` (the library yardstick, never called
   by the port; causal for flash attention, with a length mask for flash
   decode, warm and cold; events and device time) beside its bound; flash
   attention's f32 kernel's device time on the same inputs in f32; flash
   decode's device time with every row at 64, 529, 1024 and 2048
   positions.

9. the selective-scan kernel against its plain version: falcon-mamba-7b's
   prefill shape (B, L, Din, N) = (8, 512, 8192, 16) in bf16, B = 1 at
   L in {16, 128, 1000, 1024}, L = 1, N in {4, 16, 17, 64}, Din 1024 at
   B = 1 (``scan_plan`` gives 8 lanes a channel), a Din
   no block's width divides, B/C as strided column slices of one
   projection (the model's layout), f32 inputs, A and d_skip drawn for
   each channel; y and the final state
   within 2e-3 x max(1, max|output|) (``tests/test_kernels.py``'s 2e-3 for
   the Pallas twin, scaled by the output's magnitude: the kernel sums in
   other orders, fuse multiply-adds and take exp as 2^(x log2 e) on the
   special-function unit); two launches bit-equal at (8, 512, 8192, 16)
   and (1, 1024, 1024, 16), the second under CUDA's sync debug mode (the
   wrapper never synchronises with the host);
10. falcon-mamba-7b at full width and depth (64 Mamba layers, d 4096,
   bf16, seeded random weights on the card) through ``ServeEngine.generate``
   (B = 8, prompts of 512, 32 new tokens) and ``ContinuousBatcher`` (8
   slots, 16 requests of 16-1000 prompt tokens, 32 new each): the scan
   launches exactly 64 x prefills and never in decode, the attention
   kernels 0 times (a captured decode step, captured bucket prefills);
   phase 20 follows.  Kernel path against ``use_kernel=False`` (the plain
   chunked scan): depth cut to 4 in f32, logits within 2e-3 x max(1,
   max|logit|) and greedy tokens equal; full depth in bf16, logits within
   ``MAMBA_BF16_LOGIT_BOUND``;
11. qwen2-moe-a2.7b at full width and depth (24 layers, 60 routed experts
   top-4 and 4 shared, bf16): ``generate`` at B = 8, prompts of 512, 8 new
   tokens; flash attention launches exactly 24 x prefills and flash decode
   24 x decode steps; phase 20; kernel path against plain path at depth 4
   in f32, as
   in 10 (at full depth in bf16 the difference is printed, not held: a
   rounding difference can route a token to another expert).  Both paths'
   top-4 experts of every (token, MoE layer), prefill and each decode
   step, recorded by wrapping ``layers.moe``: the share of pairs whose sets
   differ, the first layer with a difference, and the worst logit
   difference over the batch rows whose routing agrees in every layer; for
   MoE layer 0 of the prefill, the flips, the plain path's router margins
   (k-th minus (k+1)-th probability) at the flips against every token's,
   and how many flips have a margin below the largest router-probability
   difference between the paths at that token (and below twice it); the
   kernel path's own margins at the flips, and how many flips have both
   paths' margins below that token's difference and below the median
   difference over the tokens that do not flip (``near_tie``); at each
   flip that is not a near tie, where layer 0's two paths part
   (``_layer0_parting``: the attention output, its projection, the
   residual, the router's input and logits, recomputed both ways and
   checked against the recorded router probabilities bit for bit; each
   one's largest difference in bf16 rounding steps, the first over one
   step, and the attention output's distance from the flash kernel's own
   arithmetic, P rounded to bf16, for either path);
12. jamba-1.5-large-398b at its reduced smoke width, with head_dim 32 for
   the smoke config's 16 (the smallest head dim the flash kernels are built
   for); 398 B parameters do not fit one card, and this is a correctness
   check, not a size: kernel path
   against plain path in f32 with both cache types; the scan launches 7 x
   prefills, flash attention 1 x prefills, the decode kernel of the cache's
   type 1 x decode steps; phase 20 with both cache types;
13. times: falcon-mamba prefill ms and decode tok/s from ``throughput_probe``
   (graph, eager, eager, graph), the profiled generates and prefills of 8;
   the scan at the prefill shape and at
   the batcher's B = 1 for L in {16, 128, 512, 1024} (CUDA events, device
   time of the call under torch.profiler: the scan kernel's mean times
   its launches a call, as the profiler drops most scan events,
   ``launch.scan_times.device_us``; time per
   (b, t, d, n) element; the plan's grid as ``scan_plan`` computes it; the
   exponentials' estimate), its plain version and its bound.

14. the Listing-1 conv kernel against its plain version at the CM zoo's
   conv shapes (the main path's (28, 16, 16) with 28 filters, lenet-28's
   two, fig2's, the tiny transformer's 1x1 on (d_model, T, 1)), the four
   cases of ``tests/test_kernels.py``, a full 256-wide crossbar (C =
   256, 1x1, 32x32), a 3x3 conv over 256 channels whose weights take
   several chunks and a stride-2 one on 11 x 17, each with int8 and f32
   wq, and strided x: rtol 1e-4
   and atol 1e-4 x max(1, max|y|) (``tests/test_kernels.py``'s 1e-4,
   scaled by the output's magnitude as for the crossbar kernel); at the
   main path's shape also against ``conv2d_mxv`` (Listing 1 per pixel, in
   numpy) on the same crossbar;
15. the quickstart (``repro_torch.launch.quickstart``) at the CM main
   path's width (c = 28, 16 x 16): compile, simulate, the reference
   executor, and every conv through ``ops.conv2d`` on the card; the conv
   kernel launches once per conv of the graph (4);
16. fault-tolerant CM serve: fig2 on ``make_chip(8, "all_to_all")`` under
   ``sample_schedule(8, 400, core_fault_rate=0.5, seed=11)`` with a
   deadline of 400 cycles and ``RetryPolicy(max_retries=3,
   backoff_cycles=32)`` (``benchmarks/bench_faults.py``), int8-exact
   weights, on the default plane (``TorchPlane`` on the card) against
   ``NumpyPlane``: serve reports (goodput, retries, remap events,
   reprogram cycles, completion and fail cycles) exactly equal, outputs
   within ``_float_tol``; then ``FaultyPlane(stuck_fraction=0.01,
   drift_sigma=0.02)`` over ``TorchPlane`` against the same over a numpy
   plane on the same int8 conductances (a drifted crossbar is not
   int8-exact, so plain ``NumpyPlane`` computes with other weights than
   ``TorchPlane``); one crossbar launch per plane call;
17. ``compile_model(analyze=True)`` on the CM main path and on lenet-28:
   no error diagnostic; a corrupted frontier table is caught as
   ``frontier-unsound``;
18. times: the conv kernel at the main path's shape (CUDA events, device
   time under torch.profiler) with its launch plan, its plain version and
   ``F.conv2d`` (cuDNN, f32 without TF32, on the dequantized weight; timed
   only; device time as in 5) beside its bound; phase 16's serve in turns
   (torch, numpy, numpy, torch); ``verify_program`` on the main path.

19. the autotuned CM programs (``configs/tuned/lenet.json``: 79 cycles;
   ``resnet4.json``: 159 cycles on a 2-chip chain mesh, every conv
   replicated x4): ``python -m repro_torch.tune --model <m> --check``
   returns 0 for both (host seconds printed); each compiled with
   ``compile_model(tune=m, quantizer=dequantize_int8)`` runs on the event
   engine, pipelined, on the images the search costs it on, on
   ``NumpyPlane`` and on ``TorchPlane`` on the card: cycles equal the
   artifact's, every ``SimStats`` field equal to the numpy plane's,
   outputs within ``_float_tol``, ``crossbar_mxv`` launches = plane calls,
   the (B, N, M) -> calls table printed; lenet again on
   ``TorchPlane(dac=True)`` (``crossbar_mxv_int8`` launches = calls,
   ``_dac_tol``); then phase 3's serve of 8 Poisson requests through
   ``CmServer`` of the tuned program and the artifact's baseline config,
   wall ms in turns (tuned, baseline, baseline, tuned), cycles of both,
   and the device's idle share over one profiled tuned serve.  The
   crossbar rows of the ``kernels`` line add the tuned runs' launches
   (``launches_by_path``).

21. the enc-dec and VLM families at full width and depth, each served on
   the inputs ``throughput_probe`` draws (the reference's
   ``default_rng(0)``: B = 8 prompts of 512 tokens and 512 standard-normal
   embeddings): qwen2-vl-7b (28 layers, d 3584, 28/4 heads of 128, G = 7,
   M-RoPE, qkv bias, untied head, bf16) and seamless-m4t-large-v2 (24
   encoder + 24 decoder layers, d 1024, 16/16 heads of 64, layernorm, tied
   256,206-row embedding, bf16).  One ``generate`` (32 new tokens, the
   captured step) with its launches held exactly: qwen2-vl 28 flash
   attention and 28 flash decode a step; seamless 72 flash attention (24
   non-causal encoder, 24 causal self, 24 non-causal cross) and 48 flash
   decode a step (self and cross), and again with 16 decoder tokens over
   the 512 frames (cross-attention with Sq < Sk); every flash call of an
   eager generate held against its plain version on its own inputs, once
   per served shape (``_HeldCalls``: 2e-3 in f32; in bf16 5e-2 and two
   bf16 steps at max|output| plus, for flash attention, 2^-8 max|V| for
   its P rounded to bf16, a bound that the plain version with a 64-key
   tile dropped, or with the decode lengths one short, must miss); phase
   20;
   ``throughput_probe`` in turns (graph, eager, eager, graph); kernel path
   against plain path as in 10 (4 + 4 layers in f32 at 2e-3, tokens equal;
   full depth in bf16 at ``BF16_LOGIT_BOUND``).  Then flash attention at
   seamless's encoder shape (8, 16, 16, 512, 64) non-causal and flash
   decode at qwen2-vl's (8, 28, 4, 2048-position cache, 128), lengths
   ``DECODE_LENGTH``, timed as in 8 beside SDPA on the same call and the
   bound; the flash rows of the ``kernels`` line gain each family
   generate's launches (``launches_by_path``) and these times.

22. training (after 21).  The flash attention backward
   (``csrc/flash_attn_bwd.cu``: ``attn_bwd_preprocess_kernel``, then
   ``attn_bwd_dkdv_wgmma_kernel`` and ``attn_bwd_dq_wgmma_kernel`` on the
   tensor cores for bf16 at D <= 128, ``attn_bwd_dkdv_kernel`` and
   ``attn_bwd_dq_kernel`` on the CUDA cores for f32 and bf16 at D 256) against
   ``attention_bwd_ref`` on the forward's own o and lse: llama's training
   shape (8, 24, 8, 512, 128) bf16 causal, the same in f32 at B = 2,
   seamless's (8, 16, 16, 512, 64) non-causal, gemma's 8/1 heads at D 256,
   D 32 in both dtypes, ragged S = 77 in both, and 16 queries over 512 keys
   non-causal: dq, dk, dv within 2e-3 x max(1, max|g|) in f32 and 2^-6 x
   max|g| in bf16 (``_bwd_limit``: two bf16 steps, inside the forward's
   5e-2 x max(1, max|g|)), each limit missed by two planted faults (query
   head 0 or one tile of 64 queries left out, ``_bwd_faults``), with
   max|g|, the limit and the errors printed; the forward's lse within 1e-5
   x max(1, |lse|) of ``attention_lse_ref`` and its output bit-equal to the
   serving call's (no lse).  Times at llama's shape in bf16 and f32: each
   backward kernel's device µs, the call's (events and device), the
   forward with lse, the plain version, SDPA's backward through autograd
   (``enable_gqa=True``; never called by the port; its device time only
   from profiles that kept every event) and the bounds.  Then
   llama3.2-3b at full width and depth trained by ``Trainer`` (B = 8 x
   512, synthetic data from seed 0, lr 3e-3, f32 moments, remat): the
   step-0 loss and every parameter's gradient against the plain path on
   the card (``GRAD_REL_L2_BOUND``, ``LOSS_REL_BOUND``; the gradient bound
   missed by the step with query head 0 left out of the kernels' dK and
   dV), one step's flash
   launches exact (56 forward, 28 backward), then 8 eager steps
   (``compile=False``) with the counts zeroed just before (448, 224 and
   8 AdamW calls), each step's loss (finite), grad norm, ms (CUDA
   events), tokens/s and peak allocated memory, one more step profiled;
   on that state and one more batch's gradients the AdamW kernels
   (``csrc/adamw.cu``, one wrapper call a step over all 254 tensors)
   against their plain version (``_adamw_check``: the norm within 1e-6
   relative, every element of p, m and v bit-equal given the kernels'
   norm, a comparison that the plain version with bc2 left out and with
   weight decay left out must each fail), with the call's time (events, device time of its
   kernels), the plain version's and the bytes bound.  Then the main
   path: a new ``Trainer`` from the same init replaying its captured step
   (``train.graphs.TrainGraph``, the default on the card: 2 eager steps
   on the capture stream, a capture, 6 replays), the counts zeroed just
   before and exact after; its 8 losses, grad norms and final parameters
   bit-equal to the eager run's and a checksum of its moments' bits the
   same; the capture's ms and peak; one replay profiled (its idle share).
   Last, the smoke width in
   f32 with head_dim 32, captured: 40 steps at ``peak_lr=1e-2`` whose loss falls as
   ``tests/test_train.py`` requires, and a run killed at step 12 and
   resumed from its step-10 checkpoint bit-equal to the uninterrupted run.
   The ``kernels`` line gains the three backward kernels ("replaces": none,
   the gradient of ``src/repro/models/layers.py:346``) and ``adamw``
   ("replaces": none, the reference's ``adamw_update``, fused by XLA).

23. every other family trains (after 22).  The selective scan's backward
   (``csrc/mamba_scan_bwd.cu``: ``scan_bwd_bounds_kernel``, the states at
   the chunks' starts; ``scan_bwd_kernel``, the reverse walk, whose
   resident warps an SM phase 1 holds to ``SCAN_BWD_MIN_WARPS``;
   ``scan_bwd_reduce_kernel``, the partial sums in a fixed order) against
   ``selective_scan_bwd_ref`` at ``SCAN_BWD_SHAPES`` (falcon-mamba's
   training shape (8, 512, 8192, 16) in bf16 and in f32 at B = 2, N 4, 17
   and 64, L 1, 77 and 1000, B = 1 at Din 1024, Din 1001, u/dt rows off
   alignment, strided B/C, jamba's smoke width in f32): du, ddt, dA, dB,
   dC, dD within 2e-3 x max|g| in f32 and 2^-6 x max|g| in bf16
   (``_scan_bwd_limit``), each limit missed by the planted faults that
   reach the gradient (g's carry dropped at a chunk's start, ddt without
   its ``A a h`` term: ``_scan_bwd_fault``), two calls bit-equal; times at
   the training shape (each kernel's device µs, the call's, events, the
   plain version, the bound and the exponentials' estimate).  Then
   falcon-mamba-7b at full width (step 0's gradients at depth 4 and
   B = 2 x 512 against the plain chunked scan, the bound missed by the
   kernel with g's carry dropped, ``_scan_carry_dropped``; ``Trainer`` at
   32 of 64 layers on B = 8 x 512, 4 steps, scan launches 64 forward and 32
   backward a step), qwen2-moe-a2.7b at full width and 6 of 24 layers
   (step 0 against the plain attention routed as the kernel path routed,
   held; routing by its own top-k and the flips printed, not held, with
   the margins at the flips that no earlier layer's flip carries,
   ``_flip_readings``; the backward's recomputed forward routing as the
   first forward, held on both paths; two backward passes bit-equal;
   flash 12 forward and 6 backward a step), qwen2-moe-a2.7b again at 4
   layers in f32, one forward a path, each routing by its own top-k, the
   flips by layer printed and held to f32 rounding
   (``phase_moe_f32_routing``, ``_f32_routing_faults``), then
   seamless-m4t-large-v2 at full width and depth (step 0 against the plain
   attention; flash 144 forward and 72 backward a step), each trained
   captured (2 eager steps, a capture, replays) with one AdamW call a
   step: each step's loss, ms, tokens/s and peak memory, the eager
   steps' peak against the capture's; and jamba at its smoke width (f32,
   head_dim 32, bf16 moments: 40 steps falling, killed at 12 and resumed
   bit-equal).
   The ``kernels`` line gains ``selective_scan_bwd`` ("replaces": none, the
   gradient of ``src/repro/models/layers.py:680``).

20. (run after phases 7, 10, 11, 12 and 21, on each model while it is on the
   card: llama3.2-3b with both caches, falcon-mamba-7b, qwen2-moe-a2.7b,
   the reduced jamba with both caches, qwen2-vl-7b, seamless-m4t-large-v2)
   the captured decode step against
   the eager one on the same inputs: prefill and 4 decode steps' logits
   bit-equal (``torch.equal``), ``generate``'s greedy tokens equal and its
   launch counts equal, and for llama3.2-3b's float cache and
   falcon-mamba-7b the batcher's tokens request by request and its launch
   counts (graph: decode step and bucket prefills captured, one pool and
   one prefill cache for all) and the card memory the batcher holds after
   its run, each way (its caches' bytes, its graph pool's segments); each graph's capture ms, warm-up and capture
   launches and launches per replay; one step's host ms and span on the
   stream (CUDA events), replayed and eager.

Each phase's wall seconds (a model's build and free included) follow it
on a ``[wall]`` line, and the sum over every phase after the last one.
Prints the card's name and power limit, then one ``{"kernels": [...]}``
line, then ``{"ok": true, "device": {...}}`` as the last line.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import io
import itertools
import json
import math
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))

from repro_torch.analysis import verify_program  # noqa: E402
from repro_torch.core import (NumpyPlane, Simulator,  # noqa: E402
                              TorchPlane, build_fig2_graph, build_lenet_like,
                              build_resnet_block_chain, compile_model,
                              dequantize_int8, make_chip, make_descriptor,
                              place_tenants)
from repro_torch.core.graph import conv2d_mxv  # noqa: E402
from repro_torch.faults import (FaultyPlane, RetryPolicy,  # noqa: E402
                                sample_schedule)
from repro_torch.configs.base import get_arch, smoke_config  # noqa: E402
from repro_torch.kernels import (_build, adamw as kadamw,  # noqa: E402
                                 add_launches, conv2d, decode_attn,
                                 decode_attn_int8, flash_attn, launch_counts,
                                 launches_apart, mamba_scan, mxv)
from repro_torch.kernels import ops as kernel_ops  # noqa: E402
from repro_torch.kernels._tensors import HEAD_DIMS  # noqa: E402
from repro_torch.kernels.ref import (quantize_crossbar, quantize_vec,  # noqa: E402
                                     selective_scan_bwd_ref,
                                     selective_scan_ref)
from repro_torch.launch import quickstart  # noqa: E402
from repro_torch.launch.decode_host_cost import host_us_per_call  # noqa: E402
from repro_torch.launch.mxv_times import (  # noqa: E402
    crossbar as _crossbar, events_ms as _events_ms,
    plane_call_us as _plane_call_us)
from repro_torch.launch.scan_times import (EXP_PER_S, scan_inputs,  # noqa: E402
                                           device_us as scan_device_us)
from repro_torch.launch.train_step_times import profile_ms, union  # noqa: E402
from repro_torch import models as port_models  # noqa: E402
from repro_torch.models import build_model, lm  # noqa: E402
from repro_torch.models.convert import decayed  # noqa: E402
from repro_torch.optim.adamw import hyper_values  # noqa: E402
from repro_torch.train import Trainer  # noqa: E402
from repro_torch.train.loop import to_device  # noqa: E402
from repro_torch.data import SyntheticLMData  # noqa: E402
from repro_torch.models.layers import kv_quantize  # noqa: E402
from repro_torch.runtime import CmServer, poisson_arrivals  # noqa: E402
from repro_torch.serve import ContinuousBatcher, Request, ServeEngine  # noqa: E402
from repro_torch.serve.engine import prefill_batch  # noqa: E402
from repro_torch.serve.graphs import DecodeGraph, PrefillGraph  # noqa: E402
from repro_torch.serve.scheduler import PREFILL_GRAPH_MAX_BUCKET  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bandwidth, f32
# outside the tensor cores, int8 tensor cores.  Rates assume the 700 W limit.
HBM_BYTES_PER_S = 3.35e12
L2_BYTES = 50e6
PEAK_OPS = {"f32": 67e12, "int8": 1979e12, "bf16": 989e12}
SOURCE = "src/repro_torch/kernels/csrc/mxv.cu"
REPLACES = {"crossbar_mxv": "src/repro/kernels/mxv.py:72",
            "crossbar_mxv_int8": "src/repro/kernels/mxv.py:98",
            "flash_attention": "src/repro/kernels/flash_attn.py:75",
            "flash_decode": "src/repro/kernels/decode_attn.py:67",
            "flash_decode_int8": "src/repro/kernels/decode_attn_int8.py:77",
            "selective_scan": "src/repro/kernels/mamba_scan.py:59",
            "crossbar_conv2d": "src/repro/kernels/conv2d.py:55"}
CONV_SOURCE = "src/repro_torch/kernels/csrc/conv2d.cu"
SCAN_SOURCE = "src/repro_torch/kernels/csrc/mamba_scan.cu"
ATTN_SOURCES = {"flash_attention": "src/repro_torch/kernels/csrc/flash_attn.cu",
                "flash_decode": "src/repro_torch/kernels/csrc/decode_attn.cu",
                "flash_decode_int8":
                    "src/repro_torch/kernels/csrc/decode_attn.cu"}
ATTN_MODS = {"flash_attention": flash_attn, "flash_decode": decode_attn,
             "flash_decode_int8": decode_attn_int8}
# the device-side name flash attention's bf16 launches carry under
# torch.profiler (its f32 kernel is F32_FLASH_KERNEL); a decode call
# launches the two DECODE_KERNELS, and its device time is their union
WGMMA_FLASH_KERNEL = "flash_attention_wgmma_kernel"
F32_FLASH_KERNEL = "flash_attention_kernel"
DECODE_KERNELS = ("decode_split_kernel", "decode_merge_kernel")
SCAN_KERNEL = "scan_lanes_kernel"        # one launch a scan call
# the crossbar kernels' names (the float one at f32 and bf16 x)
MXV_KERNELS = ("crossbar_mxv_kernel", "crossbar_mxv_int8_kernel")
LM_ARCH = "llama3.2-3b"
BATCH, PROMPT, NEW, MAX_LEN = 8, 512, 32, 2048
# the rows' length in the middle decode step of the main path's generate
# (PROMPT + NEW // 2 positions and the new one), where phase 8 times the
# decode kernels
DECODE_LENGTH = PROMPT + NEW // 2 + 1
N_REQUESTS, SLOTS = 16, 8
# bf16 logits of the kernel path against the plain path at full depth, as a
# share of max(1, max|logit|): 0.0189 measured on an H100 (PERF.md), held
# with room for other cards' cuBLAS choices
BF16_LOGIT_BOUND = 0.05
MAMBA_ARCH, MOE_ARCH, HYBRID_ARCH = ("falcon-mamba-7b", "qwen2-moe-a2.7b",
                                     "jamba-1.5-large-398b")
MOE_NEW = 8
ENCDEC_ARCH, VLM_ARCH = "seamless-m4t-large-v2", "qwen2-vl-7b"
# decoder tokens of phase 21's second seamless generate, over PROMPT
# encoder frames: cross-attention with Sq < Sk in prefill
ENCDEC_SHORT = 16
# bf16 logits of falcon-mamba-7b's kernel path against its plain path at
# full depth, as a share of max(1, max|logit|): 0.0592 on an H100 80GB HBM3
# at 700 W, the same in every run (seeded weights, deterministic kernels;
# PERF.md).  The bound, 1.25 times that, catches a failure; the f32 4-layer
# comparison at 2e-3 is the one that holds the kernel path's precision.
MAMBA_BF16_LOGIT_BOUND = 0.075
# the special-function units: 16 exponentials per clock per SM (H100 SXM,
# 132 SMs, 1,980 MHz boost clock), for the scan's estimate beside its bound
STAT_FIELDS = ("cycles", "messages", "bytes_sent")
DICT_FIELDS = ("busy", "sram_high_water")


# ------------------------------------------------------------------ helpers
def _misaligned(wq):
    """The same int8 matrix at a data pointer one byte past alignment."""
    buf = torch.empty(wq.numel() + 1, dtype=torch.int8, device=wq.device)
    view = buf[1:].view(wq.shape)
    view.copy_(wq)
    return view


def _check_float(x, wq, ws, tol):
    got = mxv.crossbar_mxv(x, wq, ws)
    want = mxv.crossbar_mxv_plain(x, wq, ws)
    torch.cuda.synchronize()
    if got.dtype != x.dtype or got.shape != want.shape:
        raise AssertionError(f"crossbar_mxv: {got.dtype} {tuple(got.shape)} "
                             f"vs {want.dtype} {tuple(want.shape)}")
    g, w = got.float(), want.float()
    # an f32 sum of N products carries rounding error of the size of its
    # terms, not of its result, and the kernel (ascending k) and cuBLAS sum
    # in different orders: atol is tol times the output's magnitude
    atol = tol * max(1.0, w.abs().max().item()) if w.numel() else tol
    if not torch.allclose(g, w, rtol=tol, atol=atol):
        raise AssertionError(f"crossbar_mxv disagrees at x {tuple(x.shape)} "
                             f"{x.dtype}, wq {tuple(wq.shape)}: max err "
                             f"{(g - w).abs().max().item()}")
    return (g - w).abs().max().item() if g.numel() else 0.0


def _check_int8(x, wq, ws):
    xq, xs = quantize_vec(x)
    got = mxv.crossbar_mxv_int8(xq, xs, wq, ws)
    want = mxv.crossbar_mxv_int8_plain(xq, xs, wq, ws)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"crossbar_mxv_int8 not bit-equal at "
                             f"{tuple(xq.shape)} x {tuple(wq.shape)}: max err "
                             f"{(got - want).abs().max().item()}")
    return (got - want).abs().max().item() if got.numel() else 0.0


def _us(v):
    """A device time in µs as printed, or "not measured"."""
    return "not measured" if v is None else f"{v:.2f} us"


def _ms(us):
    """µs (or None) as ms for the kernels line."""
    return None if us is None else us / 1e3


def _device_us(fn, name, reps=50, tries=2):
    """Mean device time of the kernel whose name contains ``name`` under
    torch.profiler (CUPTI); None where the profiler shows no device time
    in ``tries`` profiles (a profile now and then records no kernel)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            events = prof.key_averages()
        except RuntimeError as e:
            print(f"[5] torch.profiler gave no trace: {e}")
            return None
        times = []
        for e in events:
            total = getattr(e, "device_time_total", None)
            if total is None:
                total = getattr(e, "cuda_time_total", 0)
            if name in e.key and e.count and total > 0:
                times.append(total / e.count)
        if times:
            return times[0]
    return None


def _device_total_us(fn, label, reps=50, profiles=3, whole=False):
    """Device time of one call of ``fn`` under torch.profiler, over ``reps``
    calls (a library call's kernels carry the library's names): the median
    over ``profiles`` profiles, None where none shows device time.  Each
    profile gives two readings: the union of the intervals of every kernel
    and copy, divided by ``reps``, and the sum over each kernel name of
    its mean duration times its launches per call.  A profile in which
    every name has a multiple of ``reps`` events dropped none, and gives
    its union (kernels that overlap count once); one that dropped events,
    as the profiler does now and then, gives its sum (its union would read
    short).  With ``whole``, a profile that dropped events is not read but
    taken again, up to ``profiles`` more times, and the reading is None
    where no profile kept every event: for a call whose sum
    would read short too (cuDNN's attention backward, whose profiles lose
    its main kernel in some calls).  Prints the readings under ``label``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    unions, sums, used, dropped = [], [], [], []
    for _ in range(2 * profiles if whole else profiles):
        if whole and len(used) == profiles:
            break
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        spans = collections.defaultdict(list)
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                spans[e.name].append((e.time_range.start, e.time_range.end))
        if not spans:
            continue
        busy = union(itertools.chain.from_iterable(spans.values())) / reps
        total = sum(round(len(d) / reps) * statistics.fmean(b - a
                                                            for a, b in d)
                    for d in spans.values())
        drop = any(len(d) % reps for d in spans.values())
        if drop:
            dropped.append({n[:40]: len(d) for n, d in spans.items()})
            if whole:
                continue
        unions.append(busy)
        sums.append(total)
        used.append(total if drop else busy)
    if not used:
        print(f"{label}: device time not measured (" + (
            f"{len(dropped)} profile(s), each dropped events; events per "
            f"kernel in the first: {dropped[0]})" if dropped
            else "no device events)"))
        return None
    print(f"{label}: device time per call over {reps} calls, median of "
          f"{len(used)} profiles: union {statistics.median(unions):.2f} us, "
          f"sum of each kernel's mean x launches per call "
          f"{statistics.median(sums):.2f} us; taken "
          f"{statistics.median(used):.2f} us; {len(dropped)} profile(s) "
          f"dropped events" + (f", events per kernel in the first: "
                               f"{dropped[0]}" if dropped else ""))
    return statistics.median(used)


def _stats_equal(a, b, what):
    for f in STAT_FIELDS:
        if getattr(a, f) != getattr(b, f):
            raise AssertionError(f"{what}: {f} {getattr(a, f)} != "
                                 f"{getattr(b, f)}")
    for f in DICT_FIELDS:
        if dict(getattr(a, f)) != dict(getattr(b, f)):
            raise AssertionError(f"{what}: {f} differs")


def _count_calls(plane, shapes):
    """Wrap ``plane.mxv_batch`` to record each call's (B, N, M)."""
    inner = plane.mxv_batch

    def counted(desc, V):
        shapes[(V.shape[0], V.shape[1], desc.wq.shape[0])] += 1
        return inner(desc, V)

    plane.mxv_batch = counted


def _serve(prog, chip, images, arrivals, plane):
    server = CmServer(prog, chip, max_inflight=4,
                      **({} if plane is None else {"compute_plane": plane}))
    shapes = collections.Counter()
    _count_calls(server.sim.plane, shapes)
    t0 = time.perf_counter()
    rep = server.serve_images(images, arrivals)
    torch.cuda.synchronize()
    return rep, shapes, time.perf_counter() - t0, server.sim.plane


def _outputs(rep):
    return [r.output for r in sorted(rep.requests, key=lambda r: r.rid)]


def _demangle(names):
    """Short readable kernel names (``c++filt``'s, without the namespace and
    the parameter list) for mangled ones; the mangled name where
    ``c++filt`` is missing."""
    try:
        res = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True, check=True,
                             timeout=60)
        out = res.stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        return dict(zip(names, names))
    short = (d.replace("(anonymous namespace)::", "").replace("void ", "")
             for d in out)
    return {n: d.split("(")[0] for n, d in zip(names, short)}


# ------------------------------------------------------------------- phases
def phase_build():
    """Build and load the kernels; print ptxas's registers and spills for
    every kernel, and the tensor-core instructions (HMMA, HGMMA, IMMA) of
    each; the bf16 flash attention kernel must have HGMMA at every head
    dim, the int8 crossbar kernel IMMA, and no crossbar, scan, flash
    backward, scan backward or AdamW kernel spills (AdamW's four:
    ``kadamw.KERNELS``)."""
    t0 = time.perf_counter()
    lib = _build.load()
    secs = time.perf_counter() - t0
    print(f"[1] kernels built and loaded in {secs:.2f} s: "
          f"{_build.library_path()}")
    usage = _build.resource_usage()
    tc = _build.sass_counts(("HMMA", "HGMMA", "IMMA"))
    names = _demangle(sorted(set(usage) | set(tc)))
    print("[1] ptxas registers / spill stores / spill loads (bytes) per "
          "kernel: " + "; ".join(f"{names[n]} {r}/{st}/{ld}" for n, (r, st, ld)
                                  in sorted(usage.items(),
                                            key=lambda kv: names[kv[0]])))
    print("[1] tensor-core instructions per kernel (HMMA, HGMMA, IMMA): " +
          "; ".join(f"{names[n]} {c['HMMA']}, {c['HGMMA']}, {c['IMMA']}"
                    for n, c in sorted(tc.items(), key=lambda kv: names[kv[0]])
                    if any(c.values())))
    crossbar = {names[n]: u for n, u in usage.items()
                if names[n].startswith(MXV_KERNELS)}
    if len(crossbar) != 3 or any(st or ld for _, st, ld in crossbar.values()):
        raise AssertionError(f"[1] the crossbar kernels are missing or "
                             f"spill: {crossbar}")
    imma = {names[n]: c["IMMA"] for n, c in tc.items()
            if names[n].startswith(MXV_KERNELS[1])}
    if not imma or not all(imma.values()):
        raise AssertionError(f"[1] the int8 crossbar kernel is not on the "
                             f"int8 tensor cores: IMMA counts {imma}")
    print("[1] crossbar kernels, registers (no spills): " +
          "; ".join(f"{n} {r}" for n, (r, _, _) in sorted(crossbar.items()))
          + f"; IMMA in the int8 one: {imma}")
    for kname in DECODE_KERNELS:
        found = {names[n]: u for n, u in usage.items() if kname in n}
        if not found:
            raise AssertionError(f"[1] {kname} is not in the built library")
        print(f"[1] {kname}: registers / spill stores / spill loads: " +
              "; ".join(f"{n} {r}/{st}/{ld}"
                        for n, (r, st, ld) in sorted(found.items())))
    scan = {names[n]: u for n, u in usage.items()
            if SCAN_KERNEL in n}
    if not scan or any(st or ld for _, st, ld in scan.values()):
        raise AssertionError(f"[1] the scan kernel is missing or spills: "
                             f"{scan}")
    print("[1] scan kernel, registers (no spills): " +
          "; ".join(f"{n} {r}" for n, (r, _, _) in sorted(scan.items())))
    wg = {n: c["HGMMA"] for n, c in tc.items()
          if WGMMA_FLASH_KERNEL in n}
    if len(wg) != len(HEAD_DIMS) or not all(wg.values()):
        raise AssertionError(f"[1] the bf16 flash attention kernel is not on "
                             f"the tensor cores: HGMMA counts {wg}")
    bwd = {names[n]: u for n, u in usage.items() if "attn_bwd_" in n}
    bwd_wg = {names[n]: tc.get(n, {}).get("HGMMA", 0) for n in usage
              if "attn_bwd_" in n and "wgmma" in n}
    if any(st or ld for _, st, ld in bwd.values()) or \
            len(bwd_wg) != 2 * (len(HEAD_DIMS) - 1) or \
            not all(bwd_wg.values()):
        raise AssertionError(f"[1] the backward kernels spill, or its bf16 "
                             f"kernels at D <= 128 are not on the tensor "
                             f"cores: {bwd}; HGMMA counts {bwd_wg}")
    print("[1] flash backward kernels, registers (no spills): " +
          "; ".join(f"{n} {r}" for n, (r, _, _) in sorted(bwd.items()))
          + f"; HGMMA in the tensor-core ones: {bwd_wg}")
    sbwd = {names[n]: u for n, u in usage.items() if "scan_bwd_" in n}
    if len(sbwd) != 2 * len(mamba_scan.BWD_KERNELS) or any(
            st or ld for _, st, ld in sbwd.values()):
        raise AssertionError(f"[1] the scan backward kernels are missing or "
                             f"spill: {sbwd}")
    occ = {str(dt).split(".")[1]: mamba_scan.bwd_occupancy(dt)
           for dt in (torch.float32, torch.bfloat16)}
    if any(o["warps"] < SCAN_BWD_MIN_WARPS for o in occ.values()):
        raise AssertionError(f"[1] the scan backward's reverse walk keeps "
                             f"fewer than {SCAN_BWD_MIN_WARPS} warps an SM "
                             f"resident: {occ}")
    aw = {names[n]: u for n, u in usage.items() if "adamw_" in n}
    if len(aw) != len(kadamw.KERNELS) or any(st or ld
                                            for _, st, ld in aw.values()):
        raise AssertionError(f"[1] the AdamW kernels are missing or spill: "
                             f"{aw}")
    print("[1] AdamW kernels, registers (no spills): " +
          "; ".join(f"{n} {r}" for n, (r, _, _) in sorted(aw.items())))
    print("[1] scan backward kernels, registers (no spills): " +
          "; ".join(f"{n} {r}" for n, (r, _, _) in sorted(sbwd.items()))
          + "; scan_bwd_kernel resident an SM (cudaOccupancyMaxActive"
          "BlocksPerMultiprocessor): " + "; ".join(
              f"{k} {o['blocks']} blocks, {o['warps']} warps, {o['smem']} "
              f"bytes of shared memory a block" for k, o in occ.items()))
    return lib


def phase_kernels(dev):
    gen = torch.Generator().manual_seed(0)
    err = {"crossbar_mxv": 0.0, "crossbar_mxv_int8": 0.0}
    cases = []
    for m, n, bs in [(28, 252, (1, 7, 196, 256)),          # main path
                     (4, 9, (1, 100, 676)), (8, 36, (1, 100, 144)),
                     (10, 200, (1,)),                       # lenet-28
                     (5, 1, (3,)), (33, 3, (3, 9)), (129, 130, (5, 17)),
                     (1, 64, (4,)), (256, 256, (1024,)),    # edges
                     # either side of a change of mxv_plan's layout, N of
                     # 256 (16-byte rows) and 300; k in several chunks,
                     # rows not 4-byte aligned in one chunk and in several
                     (28, 256, (262, 263)), (28, 252, (524, 525)),
                     (10, 300, (524, 525)),
                     (4, 252, (2096, 2097)), (300, 300, (4,)),
                     (28, 3000, (64,)), (9, 2001, (3,)), (3, 5001, (2,))]:
        for b in bs:
            cases.append((b, n, m))
    n_cases = 0
    for b, n, m in cases:
        wq, ws = _crossbar(m, n, gen, dev)
        x = torch.randn(b, n, generator=gen).to(dev)
        for w in (wq, _misaligned(wq)):
            err["crossbar_mxv"] = max(err["crossbar_mxv"],
                                      _check_float(x, w, ws, 1e-5))
            err["crossbar_mxv_int8"] = max(err["crossbar_mxv_int8"],
                                           _check_int8(x, w, ws))
            n_cases += 2
        # two launches of each kernel bit-equal (a fixed order of sums)
        xq, xs = quantize_vec(x)
        before = dict(mxv.LAUNCHES)
        if not (torch.equal(mxv.crossbar_mxv(x, wq, ws),
                            mxv.crossbar_mxv(x, wq, ws))
                and torch.equal(mxv.crossbar_mxv_int8(xq, xs, wq, ws),
                                mxv.crossbar_mxv_int8(xq, xs, wq, ws))):
            raise AssertionError(f"crossbar kernels differ between two "
                                 f"launches at {(b, n, m)}")
        mxv.LAUNCHES.update(before)
    # strided (transposed) activations, made contiguous by the wrappers
    wq, ws = _crossbar(28, 252, gen, dev)
    xt = torch.randn(252, 64, generator=gen).to(dev).T
    if xt.is_contiguous():
        raise AssertionError("the strided case is contiguous")
    err["crossbar_mxv"] = max(err["crossbar_mxv"],
                              _check_float(xt, wq, ws, 1e-5))
    err["crossbar_mxv_int8"] = max(err["crossbar_mxv_int8"],
                                   _check_int8(xt, wq, ws))
    # bf16 activations, output in bf16
    bf_err = 0.0
    for b in (1, 196):
        x = torch.randn(b, 252, generator=gen).to(dev, torch.bfloat16)
        bf_err = max(bf_err, _check_float(x, wq, ws, 5e-2))
    # bf16 rows not 4-byte aligned (odd N), and x one element past its
    # allocation's alignment
    for b, n, m in ((7, 9, 4), (5, 131, 5), (64, 252, 28)):
        x = torch.randn(b, n, generator=gen).to(dev, torch.bfloat16)
        buf = torch.empty(b * n + 1, dtype=torch.bfloat16, device=dev)
        x_off = buf[1:].view(b, n)
        x_off.copy_(x)
        w8, s8 = _crossbar(m, n, gen, dev)
        for xx in (x, x_off):
            bf_err = max(bf_err, _check_float(xx, w8, s8, 5e-2))
    # B == 0 / M == 0 return empty results without a launch
    before = dict(mxv.LAUNCHES)
    empty = mxv.crossbar_mxv(torch.empty(0, 9, device=dev),
                             *_crossbar(4, 9, gen, dev))
    if empty.shape != (0, 4) or mxv.LAUNCHES != before:
        raise AssertionError("B == 0 must return (0, M) without a launch")
    n_cases += 12
    print(f"[2] {n_cases} kernel-vs-plain cases agree: max abs err "
          f"crossbar_mxv {err['crossbar_mxv']:.3g} (f32), {bf_err:.3g} "
          f"(bf16); crossbar_mxv_int8 {err['crossbar_mxv_int8']:.3g}; "
          f"two launches bit-equal at each of {len(cases)} shapes")
    return err


def phase_serve(name, graph, plane_kw, tol_check):
    chip = make_chip(8, "banded")
    t0 = time.perf_counter()
    prog = compile_model(graph, chip, quantizer=dequantize_int8)
    compile_s = time.perf_counter() - t0
    shp = graph.values[graph.inputs[0]].shape
    rng = np.random.default_rng(0)
    images = [rng.normal(size=shp).astype(np.float32) for _ in range(8)]
    arrivals = poisson_arrivals(8, rate=0.002, seed=7)
    def torch_plane():
        return None if plane_kw is None else TorchPlane(**plane_kw)

    ref, _, numpy_s, _ = _serve(prog, chip, images, arrivals, NumpyPlane())
    mxv.reset_launches()
    rep, shapes, torch_s, plane = _serve(prog, chip, images, arrivals,
                                         torch_plane())
    launches = dict(mxv.LAUNCHES)
    if not (isinstance(plane, TorchPlane) and plane.device.type == "cuda"):
        raise AssertionError(f"{name}: served on {plane!r}, not the card")
    _stats_equal(ref.stats, rep.stats, name)
    if rep.to_json() != ref.to_json():
        raise AssertionError(f"{name}: serve reports differ")
    worst = 0.0
    for a, b in zip(_outputs(ref), _outputs(rep)):
        for v in a:
            if b[v].shape != a[v].shape or not np.isfinite(b[v]).all():
                raise AssertionError(f"{name}: bad output {v}")
            worst = max(worst, tol_check(a[v], b[v], v))
    # wall time in turns (numpy, torch above; torch, numpy here); these
    # serves are timing runs and their launches do not count
    torch_ms = [torch_s * 1e3, _serve(prog, chip, images, arrivals,
                                      torch_plane())[2] * 1e3]
    numpy_ms = [numpy_s * 1e3, _serve(prog, chip, images, arrivals,
                                      NumpyPlane())[2] * 1e3]
    wall_ms, busy_ms, _, _ = _device_busy(
        lambda: _serve(prog, chip, images, arrivals, torch_plane()))
    mxv.LAUNCHES.update(launches)
    calls = sum(shapes.values())
    busy = "device busy not measured" if busy_ms is None else (
        f"device busy {busy_ms:.3f} ms, idle share "
        f"{1 - busy_ms / wall_ms:.4f}")
    print(f"[{name}] profiled TorchPlane serve: wall {wall_ms:.1f} ms, "
          f"{busy}")
    print(f"[{name}] compile {compile_s:.2f} s; serve wall ms in turns: "
          f"NumpyPlane {numpy_ms[0]:.1f}, TorchPlane {torch_ms[0]:.1f}, "
          f"TorchPlane {torch_ms[1]:.1f}, NumpyPlane {numpy_ms[1]:.1f}; "
          f"{calls} plane calls, launches {launches}; cycles "
          f"{rep.stats.cycles}; worst output err {worst:.3g}")
    print(f"[{name}] (B, N, M) -> calls: "
          + ", ".join(f"{k}:{v}" for k, v in sorted(shapes.items())))
    return dict(calls=calls, launches=launches, shapes=shapes,
                torch_ms=torch_ms, numpy_ms=numpy_ms,
                device_busy_ms=busy_ms, profiled_wall_ms=wall_ms)


def _float_tol(a, b, v):
    # rtol 1e-5 / atol 2e-5 is the float plane's documented bound, plus a
    # term of 1e-6 of the output's largest magnitude: after four chained f32
    # layers, an element that is a near-cancellation carries rounding error
    # of the size of the terms that cancelled.  The JAX package's own pallas
    # plane misses the bare bound on this graph too and meets this one
    # (tests/test_torch_plane.py::
    # test_main_path_tolerance_is_one_the_reference_meets).
    atol = 2e-5 + 1e-6 * float(np.abs(a).max())
    np.testing.assert_allclose(b, a, rtol=1e-5, atol=atol, err_msg=v)
    return float(np.abs(a - b).max())


def _dac_tol(a, b, v):
    scale = max(float(np.abs(a).max()), 1.0)
    err = float(np.abs(a - b).max())
    if err >= 0.05 * scale:
        raise AssertionError(f"DAC output {v}: err {err} >= 5% of {scale}")
    return err


def _bound(kind, b, n, m):
    if kind == "f32":
        nbytes = b * n * 4 + m * n + m * 4 + b * m * 4
        ops = 2 * b * n * m + b * m
    else:
        nbytes = b * n + b * 4 + m * n + m * 4 + b * m * 4
        ops = 2 * b * n * m + 2 * b * m
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _plan_text(b, n, m, dtype):
    """``mxv_plan``'s grid and layout, as phase 5 prints them."""
    p = mxv.mxv_plan(b, n, m, dtype)
    return (f"plan computed by mxv_plan: grid {p.grid[0]} x {p.grid[1]} "
            f"of {p.threads} threads, {p.mt} columns x {p.rows} rows a "
            f"block, k in {p.ks} parts of {p.kc}, {p.smem_bytes} B shared")


def phase_times(dev, paths, errs):
    gen = torch.Generator().manual_seed(1)
    out = []
    for name, kind, path in (("crossbar_mxv", "f32", paths["main"]),
                             ("crossbar_mxv_int8", "int8", paths["dac"])):
        # the shape the path launched most often (ties: the most work)
        (b, n, m), _ = max(path["shapes"].items(),
                           key=lambda kv: (kv[1], np.prod(kv[0])))
        wq, ws = _crossbar(m, n, gen, dev)
        x = torch.randn(b, n, generator=gen).to(dev)
        if kind == "f32":
            kern = lambda: mxv.crossbar_mxv(x, wq, ws)
            plain = lambda: mxv.crossbar_mxv_plain(x, wq, ws)
            wdeq = wq.float() * ws[:, None]
            lib = lambda: torch.nn.functional.linear(x, wdeq)
            lib_ok, why = True, "F.linear on the dequantized f32 matrix"
        else:
            xq, xs = quantize_vec(x)
            kern = lambda: mxv.crossbar_mxv_int8(xq, xs, wq, ws)
            plain = lambda: mxv.crossbar_mxv_int8_plain(xq, xs, wq, ws)
            wqt = wq.T
            lib = lambda: torch._int_mm(xq, wqt)
            lib_ok = b > 16 and n % 8 == 0 and m % 8 == 0
            why = ("torch._int_mm" if lib_ok else
                   f"torch._int_mm needs B > 16 and N, M multiples of 8; "
                   f"({b}, {n}, {m}) is not")
        before = dict(mxv.LAUNCHES)
        ms = _events_ms(kern)
        dev_us = _device_us(kern, f"{name}_kernel")
        host_us = host_us_per_call(kern, calls=500)
        mxv.LAUNCHES.update(before)      # timing launches do not count
        plan = _plan_text(b, n, m, torch.int8 if kind == "int8"
                          else torch.float32)
        plain_ms = _events_ms(plain)
        lib_ms = _events_ms(lib) if lib_ok else None
        lib_dev_us = _device_total_us(lib, f"[5] {name}'s library call") \
            if lib_ok else None
        bound_ms, bound_by = _bound(kind, b, n, m)
        launches = path["launches"][name]
        desc = make_descriptor(np.random.default_rng(2).normal(size=(m, n)),
                               "conv2d")
        V = np.random.default_rng(3).normal(size=(b, n)).astype(np.float32)
        call_us = _plane_call_us(TorchPlane(dev, dac=kind == "int8"), desc, V)
        numpy_call_us = _plane_call_us(NumpyPlane(), desc, V)
        mxv.LAUNCHES.update(before)
        out.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches,
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms, "shape_bnm": [b, n, m],
            "device_ms": _ms(dev_us), "library_device_ms": _ms(lib_dev_us),
            "serve_wall_ms": path["torch_ms"],
            "serve_wall_ms_numpy_plane": path["numpy_ms"],
            "plane_call_us": call_us, "numpy_plane_call_us": numpy_call_us,
            "serve_device_busy_ms": path["device_busy_ms"],
            "serve_profiled_wall_ms": path["profiled_wall_ms"],
            "wrapper_host_us": host_us,
        })
        print(f"[5] {name} at (B, N, M) = {(b, n, m)} ({plan}): "
              f"{ms * 1e3:.2f} us per launch (events, back to back), "
              f"device {_us(dev_us)}, wrapper's host time "
              f"{host_us:.2f} us a call; "
              f"plain {plain_ms * 1e3:.2f} us; library "
              f"{'n/a' if lib_ms is None else f'{lib_ms * 1e3:.2f} us'} "
              f"({why}; device {_us(lib_dev_us)}); bound "
              f"{bound_ms * 1e3:.4f} us ({bound_by}); "
              f"{launches} launches per serve; one TorchPlane call "
              f"(upload, launch, download) {call_us:.1f} us, one NumpyPlane "
              f"call {numpy_call_us:.1f} us")
    # both kernels at the main path's crossbar, smallest and largest batch
    wq, ws = _crossbar(28, 252, gen, dev)
    for b in (1, 256):
        x = torch.randn(b, 252, generator=gen).to(dev)
        xq, xs = quantize_vec(x)
        before = dict(mxv.LAUNCHES)
        t_f = _events_ms(lambda: mxv.crossbar_mxv(x, wq, ws))
        t_i = _events_ms(lambda: mxv.crossbar_mxv_int8(xq, xs, wq, ws))
        d_f = _device_us(lambda: mxv.crossbar_mxv(x, wq, ws),
                         MXV_KERNELS[0])
        d_i = _device_us(lambda: mxv.crossbar_mxv_int8(xq, xs, wq, ws),
                         MXV_KERNELS[1])
        mxv.LAUNCHES.update(before)
        print(f"[5] 28x252 at B={b}: crossbar_mxv {t_f * 1e3:.2f} us per "
              f"launch, device {_us(d_f)} "
              f"({_plan_text(b, 252, 28, torch.float32)}), "
              f"crossbar_mxv_int8 {t_i * 1e3:.2f} us, device {_us(d_i)} "
              f"({_plan_text(b, 252, 28, torch.int8)}); bounds "
              f"{_bound('f32', b, 252, 28)[0] * 1e3:.4f} / "
              f"{_bound('int8', b, 252, 28)[0] * 1e3:.4f} us")
    return out


# --------------------------------------------------------- attention phases
_all_counts = launch_counts


def _set_counts(counts):
    now = launch_counts()
    add_launches({k: counts[k] - n for k, n in now.items()})


def _zero_counts():
    _set_counts({k: 0 for k in _all_counts()})


def _attn_err(got, want, tol, what):
    g, w = got.float(), want.float()
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{what}: {got.dtype} {tuple(got.shape)} vs "
                             f"{want.dtype} {tuple(want.shape)}")
    err = (g - w).abs().max().item() if g.numel() else 0.0
    if not torch.isfinite(g).all() or not torch.allclose(g, w, rtol=tol,
                                                         atol=tol):
        raise AssertionError(f"{what}: max err {err} over tolerance {tol}")
    return err


def phase_attention_kernels(dev):
    """Kernels 4-6 against their plain versions at full-width heads."""
    cfg = get_arch(LM_ARCH)
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    gen = torch.Generator(device=dev).manual_seed(6)
    f32, bf16 = torch.float32, torch.bfloat16
    err = {n: {f32: 0.0, bf16: 0.0} for n in ATTN_MODS}
    before = _all_counts()
    n_cases = 0

    def bshd(b, s, h, dt):
        return torch.randn(b, s, h, d, generator=gen, device=dev).to(dt)

    def note(name, dt, got, want, tol, what):
        err[name][dt] = max(err[name][dt], _attn_err(got, want, tol, what))

    for b in (1, 8):
        for s in (1, 17, 128, 512, 2048):
            lengths = torch.randint(1, s + 1, (b,), generator=gen,
                                    device=dev, dtype=torch.int32)
            lengths[0] = s
            if b > 1:        # every position masked: the mean of V over S
                lengths[1] = 0
            for dt in (f32, bf16):
                tol = 2e-3 if dt == f32 else 5e-2
                what = f"B={b} S={s} {dt}"
                q, k, v = bshd(b, s, hq, dt), bshd(b, s, hkv, dt), \
                    bshd(b, s, hkv, dt)
                qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
                note("flash_attention", dt,
                     flash_attn.flash_attention(qt, kt, vt, causal=True),
                     flash_attn.flash_attention_plain(qt, kt, vt, True),
                     tol, f"flash_attention {what}")
                qd = q[:, -1]
                note("flash_decode", dt,
                     decode_attn.flash_decode(qd, kt, vt, lengths),
                     decode_attn.flash_decode_plain(qd, kt, vt, lengths),
                     tol, f"flash_decode {what}")
                (k8, ks), (v8, vs) = kv_quantize(k), kv_quantize(v)
                args = (qd, k8.transpose(1, 2), ks.transpose(1, 2),
                        v8.transpose(1, 2), vs.transpose(1, 2), lengths)
                note("flash_decode_int8", dt,
                     decode_attn_int8.flash_decode_int8(*args),
                     decode_attn_int8.flash_decode_int8_plain(*args),
                     2e-5 if dt == f32 else 5e-2,
                     f"flash_decode_int8 {what}")
                n_cases += 3
    # non-causal, the last 33 of 100 positions as queries, and 100 queries
    # over 33 keys (the first 67 rows see no key: the mean of V)
    for causal, sq, sk in ((False, 100, 100), (True, 33, 100),
                           (True, 100, 33)):
        for dt in (f32, bf16):
            q = bshd(2, sq, hq, dt).transpose(1, 2)
            k, v = (bshd(2, sk, hkv, dt).transpose(1, 2) for _ in range(2))
            note("flash_attention", dt,
                 flash_attn.flash_attention(q, k, v, causal=causal),
                 flash_attn.flash_attention_plain(q, k, v, causal),
                 2e-3 if dt == f32 else 5e-2,
                 f"flash_attention causal={causal} Sq={sq} Sk={sk} {dt}")
            n_cases += 1
    torch.cuda.synchronize()
    _set_counts(before)                # checking launches do not count
    print(f"[6] {n_cases} attention kernel-vs-plain cases agree: max abs err "
          + "; ".join(f"{n} {e[f32]:.3g} (f32), {e[bf16]:.3g} (bf16)"
                      for n, e in err.items()))
    return {n: {"f32": e[f32], "bf16": e[bf16]} for n, e in err.items()}


class _ShapeLog:
    """While entered, records the shape of every attention op the model
    calls from Python (through ``kernels.ops``), to time each kernel at the
    shape its path launches most often.  A captured decode step calls them
    in its warm-up and capture only, at the shapes its replays launch."""

    def __init__(self):
        self.calls = collections.defaultdict(list)
        self._orig = {}

    def __enter__(self):
        for name in ATTN_MODS:
            fn = getattr(kernel_ops, name)
            self._orig[name] = fn

            def logged(*args, _fn=fn, _name=name, **kw):
                self.calls[_name].append(
                    tuple(tuple(a.shape) + (str(a.dtype),) for a in args
                          if isinstance(a, torch.Tensor)))
                return _fn(*args, **kw)
            setattr(kernel_ops, name, logged)
        return self

    def __exit__(self, *exc):
        for name, fn in self._orig.items():
            setattr(kernel_ops, name, fn)

    def most_frequent(self, name):
        """The operands' shapes of the most frequent call shape."""
        calls = self.calls[name]
        if not calls:
            return None
        return collections.Counter(calls).most_common(1)[0][0]


def _lm_cfg(kv, **over):
    return dataclasses.replace(get_arch(LM_ARCH), kv_dtype=kv, **over)


def _lm_workload(vocab):
    rng = np.random.default_rng(7)
    prompts = rng.integers(0, vocab, (BATCH, PROMPT)).astype(np.int32)
    lens = rng.integers(16, 1001, N_REQUESTS)
    reqs = [rng.integers(0, vocab, (int(n),)).astype(np.int32) for n in lens]
    return prompts, reqs


def _expect(counts, want, what):
    for k, n in want.items():
        if counts[k] != n:
            raise AssertionError(f"{what}: {k} launched {counts[k]} times, "
                                 f"expected {n} (all counts {counts})")


def phase_lm_serve(model, shapes):
    """The main path: generate and continuous batching at full width, with
    a float and an int8 KV cache; launch counts read around each run, and
    the attention ops' shapes logged during ``generate``."""
    n_layers = model.cfg.n_layers
    prompts, req_prompts = _lm_workload(model.cfg.vocab_size)
    out = {}
    for kv in ("compute", "int8"):
        cfg = _lm_cfg(kv)
        dec, other = (("flash_decode", "flash_decode_int8") if kv == "compute"
                      else ("flash_decode_int8", "flash_decode"))
        eng = ServeEngine(cfg, max_len=MAX_LEN, params=model)
        _zero_counts()
        t0 = time.perf_counter()
        with shapes:
            toks = eng.generate(prompts, NEW)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        gen_counts = _all_counts()
        if toks.shape != (BATCH, NEW) or toks.min() < 0 or \
                toks.max() >= cfg.vocab_size:
            raise AssertionError(f"generate ({kv}): bad tokens {toks}")
        _expect(gen_counts, {"flash_attention": n_layers,
                             dec: n_layers * NEW, other: 0,
                             "crossbar_mxv": 0, "crossbar_mxv_int8": 0,
                             "selective_scan": 0},
                f"generate ({kv})")
        cb = ContinuousBatcher(cfg, n_slots=SLOTS, max_len=MAX_LEN,
                               params=model)
        reqs = [Request(rid=i, prompt=p, max_new=NEW)
                for i, p in enumerate(req_prompts)]
        for r in reqs:
            cb.submit(r)
        _zero_counts()
        t0 = time.perf_counter()
        cb.run_until_drained()
        torch.cuda.synchronize()
        cb_s = time.perf_counter() - t0
        cb_counts = _all_counts()
        if not all(r.done and len(r.out) == NEW for r in reqs):
            raise AssertionError(f"batcher ({kv}): requests unfinished")
        _expect(cb_counts, {"flash_attention": n_layers * N_REQUESTS,
                            dec: n_layers * cb.stats["steps"], other: 0},
                f"batcher ({kv})")
        print(f"[7] {LM_ARCH} kv={kv}: generate B={BATCH} x {PROMPT} + {NEW} "
              f"in {gen_s:.2f} s, launches {gen_counts}; batcher "
              f"{N_REQUESTS} requests in {cb_s:.2f} s, {cb.stats['steps']} "
              f"steps, utilization {cb.utilization:.3f}, launches "
              f"{cb_counts}")
        out[kv] = {"generate": gen_counts, "batcher": cb_counts}
    return out


def _logit_steps(cfg, model, prompts, steps, use_kernel, feed=None,
                 embeds=None):
    """Prefill logits, then ``steps`` decode steps' logits, each step fed
    the argmax of the last logits (greedy) or, given ``feed`` (B, steps),
    those tokens: so both paths can run on the same inputs.  A model with
    embedding inputs prefills from ``embeds`` (and, an enc-dec, the
    prompts), and the VLM's steps take their tokens' embeddings, as the
    engine feeds them."""
    batch = prefill_batch(cfg, prompts, embeds, model.device)
    with torch.no_grad():
        logits, cache = port_models.prefill(cfg, model, batch, MAX_LEN,
                                            use_kernel)
        out, fed = [logits], []
        for j in range(steps):
            tok = torch.argmax(logits, -1) if feed is None else feed[:, j]
            fed.append(tok)
            logits, cache = port_models.decode_step(
                cfg, model, cache, port_models.step_input(cfg, model, tok),
                use_kernel)
            out.append(logits)
    return out, torch.stack(fed, 1)


@contextlib.contextmanager
def _routing_log(log):
    """Record the top-k experts of every ``layers.moe`` call, as (B, T, K)
    sorted indices, by wrapping it as ``_count_calls`` wraps a plane: the
    router's logits, softmax and ``torch.topk`` again on the same input.
    Beside them each entry keeps the router's probabilities (B, T, E) and
    its margin (B, T), the k-th largest probability minus the (k+1)-th."""
    from repro_torch.models import layers
    inner = layers.moe

    def recorded(cfg, p, x, **kw):
        k = cfg.moe.top_k
        probs = torch.softmax(x.to(torch.float32) @ p["router"], dim=-1)
        top = torch.topk(probs, k + 1, dim=-1)[0]
        log.append((torch.topk(probs, k, dim=-1)[1].sort(-1).values, probs,
                    top[..., k - 1] - top[..., k]))
        return inner(cfg, p, x, **kw)

    layers.moe = recorded
    try:
        yield log
    finally:
        layers.moe = inner


def _routing_stats(logs, got, want):
    """Routing of the kernel path (``logs[0]``) against the plain path
    (``logs[1]``), one entry a MoE call, the calls of a forward in layer
    order, the prefill's first (it routes (B, T, d); a decode step (1, B,
    d), one token a row): the share of (token, layer) pairs whose top-k
    sets differ, the first layer with a difference, the batch rows whose
    routing agrees in every layer of every step, and the worst |logit
    difference| / max(1, max|logit|) over those rows.  For MoE layer 0 of
    the prefill (``layer0``): its flips; the plain path's margins at the
    flipped tokens (max, median) against its median margin over every
    token; and how many flips have a margin below the largest |router
    probability difference| between the two paths at that token
    (``explained``: the paths' inputs differ by more than the margin) or
    below twice it (``within_2x``: the k-th and (k+1)-th can each move by
    the difference, so every flip is); the kernel path's own margin at the
    flips (max, median); and the flips at which both paths' margins are
    below that token's largest difference (``both_below_own``) and below
    the median of that difference over the tokens that do not flip
    (``near_tie``: each path is nearer a tie than the paths' typical
    rounding difference, the rule that settles whether a flip is a near
    tie)."""
    if len(logs[0]) != len(logs[1]) or len(logs[0]) % len(got):
        raise AssertionError(f"routing logs of {len(logs[0])} and "
                             f"{len(logs[1])} calls for {len(got)} steps")
    per_step = len(logs[0]) // len(got)
    pairs = differ = 0
    first = None
    rows_ok = torch.ones(got[0].shape[0], dtype=torch.bool,
                         device=got[0].device)
    (k_sets, k_probs, k_margin), (p_sets, p_probs, margin) = \
        logs[0][0], logs[1][0]
    flip0 = (k_sets != p_sets).any(-1)
    gap = (k_probs - p_probs).abs().amax(-1)
    m_flip, g_flip, r_flip = margin[flip0], gap[flip0], k_margin[flip0]
    noise = gap[~flip0].median().item()
    layer0 = {
        "pairs": flip0.numel(), "flips": int(flip0.sum()),
        "flip_margin_max": m_flip.max().item() if m_flip.numel() else None,
        "flip_margin_median": (m_flip.median().item() if m_flip.numel()
                               else None),
        "margin_median": margin.median().item(),
        "prob_diff_max": gap.max().item(),
        "explained": int((m_flip < g_flip).sum()),
        "within_2x": int((m_flip < 2 * g_flip).sum()),
        "kernel_margin_max": r_flip.max().item() if r_flip.numel() else None,
        "kernel_margin_median": (r_flip.median().item() if r_flip.numel()
                                 else None),
        "both_below_own": int(((m_flip < g_flip) & (r_flip < g_flip)).sum()),
        "nonflip_diff_median": noise,
        "near_tie": int(((m_flip < noise) & (r_flip < noise)).sum())}
    # the flips that are not near ties: (row, token) and both paths'
    # router probabilities there, for ``_layer0_parting``
    far = flip0 & ~((margin < noise) & (k_margin < noise))
    layer0["far"] = [tuple(int(i) for i in rt) for rt in far.nonzero()]
    layer0["far_probs"] = (k_probs[far], p_probs[far])
    for i, ((a, *_), (b, *_)) in enumerate(zip(*logs)):
        flip = (a != b).any(-1)
        if i >= per_step:
            flip = flip.T                              # (B, T) as prefill
        pairs += flip.numel()
        differ += int(flip.sum())
        if flip.any() and (first is None or i % per_step < first):
            first = i % per_step
        rows_ok &= ~flip.any(-1)
    worst = None
    if rows_ok.any():
        worst = max(((g[rows_ok] - w[rows_ok]).abs().max()
                     / max(1.0, w[rows_ok].abs().max().item())).item()
                    for g, w in zip(got, want))
    return {"moe_layers": per_step, "pairs": pairs, "pairs_differing": differ,
            "share_differing": differ / pairs, "first_layer_differing": first,
            "rows_agreeing": int(rows_ok.sum()), "rows": len(rows_ok),
            "worst_on_agreeing_rows": worst, "layer0": layer0}


def _compare_paths(cfg, model, prompts, steps, tol, what, routing=None,
                   embeds=None):
    """Kernel path against the plain path on the same inputs; returns the
    worst |logit difference| / max(1, max|logit|) over the prefill and
    every decode step.  Given a dict ``routing``, records both paths' MoE
    routing and puts ``_routing_stats`` into it."""
    before = _all_counts()
    logs = ([], [])
    with (_routing_log(logs[0]) if routing is not None
          else contextlib.nullcontext()):
        got, fed = _logit_steps(cfg, model, prompts, steps, True,
                                embeds=embeds)
    with (_routing_log(logs[1]) if routing is not None
          else contextlib.nullcontext()):
        want, _ = _logit_steps(cfg, model, prompts, steps, False, feed=fed,
                               embeds=embeds)
    _set_counts(before)
    if routing is not None:
        routing.update(_routing_stats(logs, got, want))
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        if not torch.isfinite(g).all():
            raise AssertionError(f"{what}: non-finite logits at step {i}")
        rel = ((g - w).abs().max() / max(1.0, w.abs().max().item())).item()
        worst = max(worst, rel)
    if worst > tol:
        raise AssertionError(f"{what}: logits differ by {worst:.3g} of "
                             f"max(1, max|logit|), over {tol}")
    return worst


def _nonzero(counts):
    return {k: v for k, v in counts.items() if v}


def _step_times(step, reps=5):
    """Median host ms to enqueue ``step()`` and median ms between CUDA events
    recorded around it (the step's span on the stream), the card
    synchronised before each."""
    host, span = [], []
    for _ in range(reps):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        e0.record()
        t0 = time.perf_counter()
        step()
        host.append((time.perf_counter() - t0) * 1e3)
        e1.record()
        torch.cuda.synchronize()
        span.append(e0.elapsed_time(e1))
    return statistics.median(host), statistics.median(span)


def _batcher_memory(cb):
    """Card memory a batcher holds, MiB: {"caches": the bytes of its live
    cache and of its bucket prefills' cache, "prefill_caches": how many of
    those there are, "pool": the segments of its graphs' memory pool,
    "pool_streams": the streams they were allocated on}."""
    caches = [cb.cache] + list({id(g.cache): g.cache for g in
                                cb.prefill_graphs.values()}.values())
    out = {"caches": sum(t.numel() * t.element_size() for c in caches
                         for e in c["layers"] for t in e.values()) / 2**20,
           "prefill_caches": len(caches) - 1, "pool": 0.0, "pool_streams": 0}
    if cb.graph is not None:
        pool = tuple(cb.graph.graph.pool())
        segs = [s for s in torch.cuda.memory_snapshot()
                if tuple(s["segment_pool_id"]) == pool]
        out["pool"] = sum(s["total_size"] for s in segs) / 2**20
        out["pool_streams"] = len({s["stream"] for s in segs})
    return out


def _memory_text(m):
    return (f"caches {m['caches']:.1f} MiB ({m['prefill_caches']} prefill "
            f"cache(s)), graph pool {m['pool']:.1f} MiB on "
            f"{m['pool_streams']} stream(s)")


def phase_graph_vs_eager(tag, cfg, model, prompts, new, reqs=None,
                         steps=4, embeds=None):
    """The captured decode step (``DecodeGraph``, the engines' default on
    the card) against the eager one on the same inputs: prefill and
    ``steps`` decode steps' logits bit-equal, fed the eager path's greedy
    tokens; ``generate``'s greedy tokens and launch counts equal; given
    ``reqs`` (prompts), the batcher's tokens request by request and its
    launch counts too.  Also the graph's capture ms, its warm-up and
    capture launches (kept out of ``LAUNCHES``), its launches per replay,
    and one step's host ms and span on the stream, both ways.  A model
    with embedding inputs takes ``embeds`` (the enc-dec's graph is made
    for their S_enc)."""
    before = _all_counts()
    want, fed = _logit_steps(cfg, model, prompts, steps, True, embeds=embeds)
    batch = prefill_batch(cfg, prompts, embeds, model.device)
    with torch.no_grad():
        graph = DecodeGraph(cfg, model, prompts.shape[0], MAX_LEN,
                            enc_len=port_models.encoder_frames(cfg, batch))
        got = [port_models.prefill(cfg, model, batch, MAX_LEN,
                                   cache=graph.cache)[0]]
        for j in range(steps):
            got.append(graph.replay(port_models.step_input(
                cfg, model, fed[:, j])).clone())
        for j, (g, w) in enumerate(zip(got, want)):
            if not torch.equal(g, w):
                rel = ((g - w).abs().max()
                       / max(1.0, w.abs().max().item())).item()
                raise AssertionError(f"[20] {tag}: logits of step {j} differ "
                                     f"between graph and eager ({rel:.3g} of "
                                     f"max(1, max|logit|))")
        tok = port_models.step_input(cfg, model, fed[:, -1])
        replay_ms = _step_times(lambda: graph.replay(tok))
        eager_ms = _step_times(lambda: port_models.decode_step(
            cfg, model, graph.cache, tok))
    out = {"capture_ms": graph.capture_ms,
           "setup_launches": _nonzero(graph.setup_launches),
           "launches_per_replay": _nonzero(graph.launches),
           "step_host_ms": {"graph": replay_ms[0], "eager": eager_ms[0]},
           "step_span_ms": {"graph": replay_ms[1], "eager": eager_ms[1]},
           "logit_steps_bit_equal": steps + 1}
    del graph, got, want
    runs = {}
    for compile in (True, False):
        eng = ServeEngine(cfg, max_len=MAX_LEN, params=model, compile=compile)
        _zero_counts()
        t0 = time.perf_counter()
        toks = eng.generate(prompts, new, embeds=embeds)
        torch.cuda.synchronize()
        runs[compile] = (toks, _all_counts(), time.perf_counter() - t0)
        del eng
    if not np.array_equal(runs[True][0], runs[False][0]):
        raise AssertionError(f"[20] {tag}: generate's tokens differ between "
                             f"graph and eager")
    _expect(runs[True][1], runs[False][1], f"[20] {tag} generate (graph "
            f"against eager)")
    out["generate_s"] = {"graph, capture included": runs[True][2],
                         "eager": runs[False][2]}
    out["generate_launches"] = _nonzero(runs[True][1])
    if reqs is not None:
        served, held = {}, {}
        for compile in (True, False):
            cb = ContinuousBatcher(cfg, n_slots=SLOTS, max_len=MAX_LEN,
                                   params=model, compile=compile)
            rs = [Request(rid=i, prompt=p, max_new=new)
                  for i, p in enumerate(reqs)]
            for r in rs:
                cb.submit(r)
            _zero_counts()
            t0 = time.perf_counter()
            cb.run_until_drained()
            torch.cuda.synchronize()
            served[compile] = ([r.out for r in rs], _all_counts(),
                               time.perf_counter() - t0)
            held["graph" if compile else "eager"] = _batcher_memory(cb)
        if served[True][0] != served[False][0]:
            raise AssertionError(f"[20] {tag}: the batcher's tokens differ "
                                 f"between graph and eager")
        _expect(served[True][1], served[False][1],
                f"[20] {tag} batcher (graph against eager)")
        out["batcher_s"] = {"graph, captures included": served[True][2],
                            "eager": served[False][2]}
        out["batcher_held_mib"] = held
    _set_counts(before)
    _free()
    print(f"[20] {tag}: graph against eager on the same inputs: prefill and "
          f"{steps} decode steps' logits bit-equal, generate's "
          f"{prompts.shape[0]} x {new} tokens equal, launches equal "
          f"{out['generate_launches']}"
          + ("" if reqs is None else
             f"; batcher's {len(reqs)} requests equal token for token, "
             f"launches equal; card memory it holds after its run: "
             + "; ".join(f"{way} {_memory_text(m)}"
                         for way, m in out["batcher_held_mib"].items()))
          + f"; capture {out['capture_ms']:.1f} ms, warm-up and capture "
          f"launches {out['setup_launches']} (not counted), per replay "
          f"{out['launches_per_replay']}; one step's host ms / span on the "
          f"stream: graph {replay_ms[0]:.3f} / {replay_ms[1]:.3f}, eager "
          f"{eager_ms[0]:.3f} / {eager_ms[1]:.3f}; seconds "
          + ", ".join(f"{k} {v:.2f}" for d in ("generate_s", "batcher_s")
                      for k, v in out.get(d, {}).items()))
    return out


def _bucket_prefills(model, buckets=(16, 128, 512, 1024), reps=3):
    """A B = 1 bucket prefill (the batcher's), eager and replayed from a
    ``PrefillGraph``: each one's wall ms (median of ``reps``, synchronised)
    and, over one profiled call, wall ms, device-busy ms and idle share;
    the bucket captured by the batcher or not.  Logits bit-equal."""
    cfg = model.cfg
    rng = np.random.default_rng(12)
    before = _all_counts()
    out = {}
    for bucket in buckets:
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, bucket)),
                               device=model.device)
        graph = PrefillGraph(cfg, model, 1, bucket, MAX_LEN)
        row = {"captured": bucket <= PREFILL_GRAPH_MAX_BUCKET,
               "capture_ms": graph.capture_ms}
        with torch.no_grad():
            ways = {"eager": lambda: lm.prefill(cfg, model, toks, MAX_LEN)[0],
                    "graph": lambda: graph.replay(toks)}
            if not torch.equal(ways["eager"](), ways["graph"]()):
                raise AssertionError(f"prefill bucket {bucket}: graph and "
                                     f"eager logits differ")
            for way, run in ways.items():
                walls = []
                for _ in range(reps):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    run()
                    torch.cuda.synchronize()
                    walls.append((time.perf_counter() - t0) * 1e3)
                w, b, n, _ = _device_busy(run)
                row[way] = {"wall_ms": statistics.median(walls),
                            "profiled_wall_ms": w, "busy_ms": b,
                            "idle_share": None if b is None else 1 - b / w,
                            "device_events": n}
        out[bucket] = row
        del graph
    _set_counts(before)
    _free()
    return out


def _print_prefills(tag, arch, rows):
    print(f"[{tag}] {arch} B = 1 bucket prefill (the batcher's), eager and "
          f"replayed: " + "; ".join(
              f"bucket {b}: " + ", ".join(
                  f"{way} {r[way]['wall_ms']:.2f} ms (profiled: wall "
                  f"{r[way]['profiled_wall_ms']:.2f}, busy "
                  f"{_ms_text(r[way]['busy_ms'])}, idle share "
                  f"{_share_text(r[way]['idle_share'])})"
                  for way in ("eager", "graph"))
              + f", captured by the batcher: {r['captured']}"
              for b, r in rows.items()))


def _ms_text(ms):
    return "not measured" if ms is None else f"{ms:.2f} ms"


def _share_text(x):
    return "not measured" if x is None else f"{x:.4f}"


def _probe_turns(cfg, model):
    """``throughput_probe`` in turns, graph, eager, eager, graph."""
    out = []
    for compile in (True, False, False, True):
        eng = ServeEngine(cfg, max_len=PROMPT + NEW + 1, params=model,
                          compile=compile)
        out.append((compile, eng.throughput_probe(BATCH, PROMPT, NEW)))
        del eng
    return out


def _profiled_generates(cfg, model, prompts):
    """One profiled ``generate`` each way, graph then eager, after a call
    that captures the graph: {way: (wall ms, busy ms, device events, host
    ops, wall ms of the same call unprofiled, (wall ms, busy ms) of a call
    profiled for device activity only)}.  The full profile's idle share is
    the measurement; the profiler adds host time to every graph launch
    (one record per replayed kernel), so the device-only profile, whose
    wall and busy time come from one call too, is the second reading, and
    busy time over the unprofiled call's wall an estimate from two."""
    out = {}
    for compile in (True, False):
        eng = ServeEngine(cfg, max_len=MAX_LEN, params=model, compile=compile)
        eng.generate(prompts, 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.generate(prompts, NEW)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        device_only = _device_busy(lambda: eng.generate(prompts, NEW),
                                   host_ops=False)[:2]
        out["graph" if compile else "eager"] = _device_busy(
            lambda: eng.generate(prompts, NEW)) + (wall, device_only)
        del eng
    return out


def _print_probes(tag, arch, probes, extra=""):
    print(f"[{tag}] {arch} throughput_probe(B=8, prompt=512, 32 tokens) in "
          f"turns: " + "; ".join(
              f"{'graph' if c else 'eager'}: prefill "
              f"{p['prefill_s'] * 1e3:.1f} ms, decode "
              f"{p['decode_tok_per_s']:.1f} tok/s" for c, p in probes)
          + extra)


def _print_profiled(tag, arch, profiled):
    for way, (wall_ms, busy_ms, n_dev, host, plain_wall,
              (d_wall, d_busy)) in profiled.items():
        busy = "device busy not measured" if busy_ms is None else (
            f"device busy {busy_ms:.1f} ms, idle share "
            f"{1 - busy_ms / wall_ms:.4f}")
        d_busy_text = "device busy not measured" if d_busy is None else (
            f"device busy {d_busy:.1f} ms, idle share "
            f"{1 - d_busy / d_wall:.4f}")
        est = "" if busy_ms is None else (
            f", estimate from two calls (busy above over the unprofiled "
            f"wall) {1 - busy_ms / plain_wall:.4f}")
        print(f"[{tag}] profiled {arch} generate (B=8, 512 + 32, kernel "
              f"path, {way}): wall {wall_ms:.1f} ms, {busy}, {n_dev} device "
              f"events; profiled for device activity only: wall "
              f"{d_wall:.1f} ms, {d_busy_text}; unprofiled wall "
              f"{plain_wall:.1f} ms{est}; host ops by self CPU ms: "
              + ", ".join(f"{k} x{n} {ms:.1f}" for k, n, ms in host))


def _profiled_json(profiled):
    out = {}
    for way, (w, b, n, _, *more) in profiled.items():
        out[way] = {"wall_ms": w, "device_busy_ms": b,
                    "idle_share": None if b is None else 1 - b / w,
                    "device_events": n}
        if more:
            plain, (d_wall, d_busy) = more
            out[way].update(
                device_only={"wall_ms": d_wall, "device_busy_ms": d_busy,
                             "idle_share": None if d_busy is None
                             else 1 - d_busy / d_wall},
                unprofiled_wall_ms=plain,
                idle_share_estimate=None if b is None else 1 - b / plain)
    return out


def phase_lm_paths(dev, model):
    """The kernel path against ``use_kernel=False`` on the card."""
    prompts, _ = _lm_workload(model.cfg.vocab_size)
    res = {}
    small = build_model(_lm_cfg("compute", n_layers=4,
                                param_dtype="float32",
                                compute_dtype="float32"), dev, seed=1)
    for kv in ("compute", "int8"):
        cfg4 = dataclasses.replace(small.cfg, kv_dtype=kv)
        res[f"f32_4layer_{kv}"] = _compare_paths(
            cfg4, small, prompts, 4, 2e-3, f"f32 4-layer kv={kv}")
        before = _all_counts()
        toks = [ServeEngine(cfg4, max_len=MAX_LEN, params=small,
                            use_kernel=use).generate(prompts, NEW)
                for use in (True, False)]
        _set_counts(before)
        res[f"f32_4layer_{kv}_tokens_equal"] = float(
            np.mean(toks[0] == toks[1]))
        # with an int8 cache, f32 rounding differences flip an int8 code
        # now and then, and a flipped code moves the logits by more than
        # rounding: there the share of equal tokens is reported, not held
        if kv == "compute" and not np.array_equal(toks[0], toks[1]):
            raise AssertionError(f"f32 4-layer kv={kv}: greedy tokens differ "
                                 f"between the kernel and plain paths")
        res[f"bf16_{kv}"] = _compare_paths(
            _lm_cfg(kv), model, prompts, 4, BF16_LOGIT_BOUND,
            f"bf16 {model.cfg.n_layers}-layer kv={kv}")
    del small
    torch.cuda.empty_cache()
    print("[7] kernel path vs plain path, worst |logit diff| / max(1, "
          "max|logit|): " + ", ".join(f"{k} {v:.3g}" for k, v in res.items())
          + f" (f32 bound 2e-3, bf16 bound {BF16_LOGIT_BOUND}; a "
          f"'tokens_equal' entry is the share of equal greedy tokens, held "
          f"to 1 for the float cache)")
    return res


def _device_busy(run, host_ops=True):
    """Run ``run()`` under torch.profiler; (wall ms, device-busy ms, device
    events, the host ops with the most self CPU time): busy is the union
    of the intervals of every device event (kernels, copies), None where
    the profiler shows none.  ``host_ops=False`` records device activity
    only (no host ops)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CUDA]
    if host_ops:
        activities.append(ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = [(e.time_range.start, e.time_range.end)
             for e in prof.events() if e.device_type == DeviceType.CUDA]
    host = sorted(((e.key, e.count, e.self_cpu_time_total / 1e3)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CPU),
                  key=lambda r: -r[2])[:8]
    if not spans:
        return wall * 1e3, None, 0, host
    return wall * 1e3, union(spans) / 1e3, len(spans), host


def _attn_bound(b, hq, hkv, sq, sk, d, elem, causal=True):
    """Flash attention: every input read once, the output written once; 4 d
    operations per unmasked (query, key) pair and head."""
    off = sk - sq
    pairs = sum(min(sk, max(0, i + 1 + off)) for i in range(sq)) \
        if causal else sq * sk
    nbytes = elem * (2 * b * hq * sq * d + 2 * b * hkv * sk * d)
    ops = 4 * d * pairs * b * hq
    t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS["bf16"] * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def _decode_bound(b, hq, hkv, s, d, lengths, q_elem, kv_elem, scaled):
    """Decode over the positions ``< length`` of each row: those K/V rows
    (and scales) read once, q read and the output written once."""
    n = int(torch.clamp(lengths.to(torch.int64), 0, s).sum().item())
    nbytes = (2 * n * hkv * d * kv_elem + (2 * n * hkv * 4 if scaled else 0)
              + 2 * b * hq * d * q_elem)
    ops = 4 * d * hq * n
    t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS["bf16"] * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def _time_attention(name, shapes, dev):
    """ms, device µs, plain ms, library ms and device µs, and bound of
    ``name`` at the shape its path launched most often; for flash attention
    also the f32 kernel's device µs on the same inputs in f32."""
    import torch.nn.functional as F
    gen = torch.Generator(device=dev).manual_seed(8)
    shp = shapes.most_frequent(name)
    mod = ATTN_MODS[name]
    f32_dev_us, decode, cold, lib_cold = None, None, None, None
    if name == "flash_attention":
        kname = WGMMA_FLASH_KERNEL
        (b, hq, sq, d, dts), (_, hkv, sk, _, _) = shp[0], shp[1]
        dt = getattr(torch, dts.split(".")[-1])
        q = torch.randn(b, sq, hq, d, generator=gen, device=dev).to(dt)
        k, v = (torch.randn(b, sk, hkv, d, generator=gen, device=dev).to(dt)
                for _ in range(2))
        args = tuple(x.transpose(1, 2) for x in (q, k, v))
        kern = lambda: mod.flash_attention(*args, causal=True)
        plain = lambda: mod.flash_attention_plain(*args, True)
        lib = lambda: F.scaled_dot_product_attention(
            *args, is_causal=True, enable_gqa=True)
        bound, by = _attn_bound(b, hq, hkv, sq, sk, d, q.element_size())
        desc = (b, hq, hkv, sq, sk, d, dts)
        if dt != torch.bfloat16:
            kname = F32_FLASH_KERNEL
        else:          # the f32 kernel, which f32 callers get, on f32 copies
            args32 = tuple(x.float() for x in args)
            before = _all_counts()
            f32_dev_us = _device_us(
                lambda: mod.flash_attention(*args32, causal=True),
                F32_FLASH_KERNEL, reps=20, tries=3)
            _set_counts(before)
            del args32
    else:
        (b, hq, d, dts), (_, hkv, s, _, kvs) = shp[0], shp[1]
        dt = getattr(torch, dts.split(".")[-1])
        lengths = torch.full((b,), DECODE_LENGTH, dtype=torch.int32,
                             device=dev)
        q = torch.randn(b, hq, d, generator=gen, device=dev).to(dt)
        k, v = (torch.randn(b, s, hkv, d, generator=gen, device=dev)
                for _ in range(2))
        mask = (torch.arange(s, device=dev)[None] < lengths[:, None].long()
                )[:, None, None, :]
        kt, vt = k.to(dt).transpose(1, 2), v.to(dt).transpose(1, 2)
        lib = lambda: F.scaled_dot_product_attention(
            q[:, :, None], kt, vt, attn_mask=mask, enable_gqa=True)
        if name == "flash_decode":
            args = (q, kt, vt, lengths)
            kern = lambda: mod.flash_decode(*args)
            plain = lambda: mod.flash_decode_plain(*args)
            elem, scaled = kt.element_size(), False
        else:
            (k8, ks), (v8, vs) = kv_quantize(k), kv_quantize(v)
            args = (q, k8.transpose(1, 2), ks.transpose(1, 2),
                    v8.transpose(1, 2), vs.transpose(1, 2), lengths)
            kern = lambda: mod.flash_decode_int8(*args)
            plain = lambda: mod.flash_decode_int8_plain(*args)
            lib, elem, scaled = None, 1, True   # no library int8-KV call
        bound, by = _decode_bound(b, hq, hkv, s, d, lengths,
                                  q.element_size(), elem, scaled)
        desc = (b, hq, hkv, s, d, dts, "lengths",
                [int(x) for x in lengths.tolist()])
        plan = decode_attn.decode_plan(b, hq, hkv, s, d)
        rows = torch.where(lengths <= 0, s, torch.clamp(lengths, max=s))
        decode = dict(plan=plan, plan_blocks=int(
            (-(-rows // plan.chunk)).sum().item()) * hkv * plan.groups)
        # the blocks that worked, counted on the card: a workspace filled
        # with NaN shows which partials the split kernel wrote, and the
        # output is the same bit for bit (the merge reads no other)
        counts = _all_counts()
        ws = torch.full(plan.workspace, float("nan"), device=dev)
        got = mod.launch(*args, workspace=ws)
        if not torch.equal(got, kern()):
            raise AssertionError(f"[8] {name}: a NaN-filled workspace "
                                 f"changed the output")
        decode["written_blocks"] = decode_attn.written_blocks(plan, ws)
        if decode["written_blocks"] != decode["plan_blocks"]:
            raise AssertionError(f"[8] {name}: {decode['written_blocks']} "
                                 f"split blocks wrote partials, the plan "
                                 f"gives {decode['plan_blocks']}")
        decode["host_us"] = host_us_per_call(kern)
        _set_counts(counts)
        # the cache as a decode step finds it, cold in L2 (28 layers' caches
        # lie between two reads of one): calls rotate over copies of the
        # cache whose bytes read add up to 1.5 x the L2
        read = 2 * int(rows.sum().item()) * hkv * d * elem
        copies = [args] + [tuple(t.clone() if t.dim() == 4 else t
                                 for t in args)
                           for _ in range(math.ceil(1.5 * L2_BYTES / read))]
        call, cold_args = getattr(mod, name), itertools.cycle(copies)
        cold = lambda: call(*next(cold_args))
        decode["copies"] = len(copies)
        if lib is not None:
            lib_args = itertools.cycle([(kt, vt)] + [
                (c[1], c[2]) for c in copies[1:]])
            lib_cold = lambda: F.scaled_dot_product_attention(
                q[:, :, None], *next(lib_args), attn_mask=mask,
                enable_gqa=True)
    before = _all_counts()
    ms = _events_ms(kern, reps=20, trials=5, warmup=3)
    if decode is None:
        dev_us = _device_us(kern, kname, reps=20)
    else:            # two kernels a call: the union of their intervals
        dev_us = _device_total_us(kern, f"[8] {name} call")
        for kn in DECODE_KERNELS:
            decode[kn + "_us"] = _device_us(kern, kn, reps=20, tries=3)
        decode["cold_us"] = _device_total_us(
            cold, f"[8] {name} call, cold in L2")
    _set_counts(before)
    plain_ms = _events_ms(plain, reps=5, trials=3, warmup=1)
    lib_ms = None if lib is None else _events_ms(lib, reps=20, trials=5,
                                                 warmup=3)
    lib_dev_us = None if lib is None else _device_total_us(
        lib, f"[8] {name}'s SDPA")
    if decode is not None:
        decode["lib_cold_us"] = None if lib_cold is None else \
            _device_total_us(lib_cold, f"[8] {name}'s SDPA, cold in L2")
    return dict(shape=desc, ms=ms, dev_us=dev_us, plain_ms=plain_ms,
                lib_ms=lib_ms, lib_dev_us=lib_dev_us, bound_ms=bound,
                bound_by=by, f32_dev_us=f32_dev_us, decode=decode)


def _decode_by_length(dev, lengths=(64, 529, 1024, 2048)):
    """flash_decode's device time in bf16 at llama3.2-3b's decode heads
    over a MAX_LEN-position cache, every row at each length: {length: (the
    call's, the split kernel's, the merge kernel's µs)}, from one chunk a
    row (the split kernel's latency, on 64 blocks) to the whole cache (2048
    blocks, 67 MB)."""
    cfg = get_arch(LM_ARCH)
    b, hq, hkv, d = BATCH, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    gen = torch.Generator(device=dev).manual_seed(9)
    q = torch.randn(b, hq, d, generator=gen, device=dev).bfloat16()
    k, v = (torch.randn(b, MAX_LEN, hkv, d, generator=gen, device=dev)
            .bfloat16().transpose(1, 2) for _ in range(2))
    out = {}
    before = _all_counts()
    for n in lengths:
        rows = torch.full((b,), n, dtype=torch.int32, device=dev)
        call = lambda: decode_attn.flash_decode(q, k, v, rows)
        out[n] = (_device_total_us(
                      call, f"[8] flash_decode, every row at {n}"),
                  *(_device_us(call, kn, reps=20, tries=3)
                    for kn in DECODE_KERNELS))
    _set_counts(before)
    return out


def phase_lm_times(dev, model, serve, shapes):
    prompts, _ = _lm_workload(model.cfg.vocab_size)
    cfg = _lm_cfg("compute")
    before = _all_counts()
    probes = _probe_turns(cfg, model)
    plain_probe = ServeEngine(cfg, max_len=PROMPT + NEW + 1, params=model,
                              use_kernel=False).throughput_probe(
                                  BATCH, PROMPT, NEW)
    int8_probe = ServeEngine(_lm_cfg("int8"), max_len=PROMPT + NEW + 1,
                             params=model).throughput_probe(BATCH, PROMPT,
                                                            NEW)
    profiled = _profiled_generates(cfg, model, prompts)
    engine_prefill = _device_busy(lambda: lm.prefill(
        cfg, model, torch.as_tensor(prompts, dtype=torch.int64,
                                    device=model.device), MAX_LEN))
    prefills = _bucket_prefills(model)
    _set_counts(before)
    _print_probes(8, LM_ARCH, probes,
                  f"; plain path (graph): prefill "
                  f"{plain_probe['prefill_s'] * 1e3:.1f} ms, decode "
                  f"{plain_probe['decode_tok_per_s']:.1f} tok/s; int8 KV "
                  f"(graph): prefill {int8_probe['prefill_s'] * 1e3:.1f} ms, "
                  f"decode {int8_probe['decode_tok_per_s']:.1f} tok/s")
    _print_profiled(8, LM_ARCH, profiled)
    w, b = engine_prefill[:2]
    print(f"[8] {LM_ARCH} engine prefill B={BATCH} x {PROMPT} (eager), "
          f"profiled: wall {w:.2f} ms, busy {_ms_text(b)}, idle share "
          f"{_share_text(None if b is None else 1 - b / w)}")
    _print_prefills(8, LM_ARCH, prefills)
    wall_ms, busy_ms, n_dev = profiled["graph"][:3]
    times = {}
    for name in ATTN_MODS:
        t = _time_attention(name, shapes, dev)
        times[name] = t
        kv = "int8" if name == "flash_decode_int8" else "compute"
        per_gen = serve[kv]["generate"][name]
        if name == "flash_attention":
            print(f"[8] flash_attention's f32 CUDA-core kernel "
                  f"({F32_FLASH_KERNEL}) at {t['shape'][:6]} in f32: device "
                  f"{_us(t['f32_dev_us'])}")
        if t["decode"] is not None:
            dec = t["decode"]
            plan = dec["plan"]
            print(f"[8] {name} split-KV plan at {t['shape'][:5]} (computed "
                  f"by decode_plan): split grid {plan.split_grid}, "
                  f"{dec['plan_blocks']} of whose blocks start below their "
                  f"row's length, merge grid {plan.merge_grid}; on the "
                  f"card {dec['written_blocks']} split blocks wrote "
                  f"partials; host {dec['host_us']:.2f} us per call (1000 "
                  f"back to back, perf_counter); device: split "
                  f"{_us(dec['decode_split_kernel_us'])}, merge "
                  f"{_us(dec['decode_merge_kernel_us'])}, the call "
                  f"(union) {_us(t['dev_us'])}; cold in L2 (calls rotating "
                  f"over {dec['copies']} copies of the cache): the call "
                  f"{_us(dec['cold_us'])}, SDPA "
                  f"{_us(dec['lib_cold_us']) if t['lib_ms'] else 'n/a'}")
        lib_s = "n/a" if t["lib_ms"] is None else \
            f"{t['lib_ms'] * 1e3:.2f} us, device {_us(t['lib_dev_us'])}"
        print(f"[8] {name} at {t['shape']}: {t['ms'] * 1e3:.2f} us per "
              f"launch (events), device {_us(t['dev_us'])}; plain "
              f"{t['plain_ms'] * 1e3:.2f} us; library {lib_s}; bound "
              f"{t['bound_ms'] * 1e3:.2f} us ({t['bound_by']}); {per_gen} "
              f"launches per generate")
    by_length = _decode_by_length(dev)
    print("[8] flash_decode bf16 at (8, 24, 8, 2048, 128), device time by "
          "row length (every row at it), the call (split + merge): " +
          "; ".join(f"{n}: {_us(a)} ({_us(sp)} + {_us(mg)})"
                    for n, (a, sp, mg) in by_length.items()))
    times["flash_decode"]["decode"]["by_length_us"] = by_length
    return dict(probes=probes, plain_probe=plain_probe,
                int8_probe=int8_probe, wall_ms=wall_ms, busy_ms=busy_ms,
                device_events=n_dev, times=times,
                profiled=_profiled_json(profiled),
                engine_prefill=_profiled_json({"eager": engine_prefill}),
                bucket_prefills=prefills)


def attention_kernel_rows(errs, serve, times, lm_paths, graph_runs):
    rows = []
    for name in ATTN_MODS:
        t = times["times"][name]
        kv = "int8" if name == "flash_decode_int8" else "compute"
        rows.append({
            "name": name, "route": "cuda", "source": ATTN_SOURCES[name],
            "replaces": REPLACES[name],
            "launches": serve[kv]["generate"][name],
            "max_abs_err": errs[name]["f32"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["lib_ms"],
            "max_abs_err_bf16": errs[name]["bf16"], "shape": t["shape"],
            "device_ms": _ms(t["dev_us"]),
            "library_device_ms": _ms(t["lib_dev_us"]),
            "launches_batcher": serve[kv]["batcher"][name],
        })
        if t["decode"] is not None:
            dec = t["decode"]
            rows[-1]["split_kv"] = {
                "written_blocks": dec["written_blocks"],
                "host_ms": _ms(dec["host_us"]),
                "split_device_ms": _ms(dec["decode_split_kernel_us"]),
                "merge_device_ms": _ms(dec["decode_merge_kernel_us"]),
                "device_ms_cold": _ms(dec["cold_us"]),
                "library_device_ms_cold": _ms(dec["lib_cold_us"])}
            if "by_length_us" in dec:
                rows[-1]["split_kv"]["device_ms_by_length"] = {
                    n: [_ms(us) for us in t3]
                    for n, t3 in dec["by_length_us"].items()}
    rows[0]["device_ms_f32_kernel"] = _ms(times["times"][
        "flash_attention"]["f32_dev_us"])
    rows[0]["lm"] = {
        "arch": LM_ARCH,
        "probes": [{"graph": c, **p} for c, p in times["probes"]],
        "plain_probe": times["plain_probe"],
        "int8_probe": times["int8_probe"],
        "generate_wall_ms_profiled": times["wall_ms"],
        "generate_device_busy_ms": times["busy_ms"],
        "generate_device_events": times["device_events"],
        "generate_profiled": times["profiled"],
        "engine_prefill_profiled": times["engine_prefill"],
        "bucket_prefills": times["bucket_prefills"],
        "graph_vs_eager": graph_runs,
        "logit_diff_kernel_vs_plain": lm_paths}
    return rows


# ------------------------------------------------ Mamba, MoE, hybrid phases
def _rel_err(got, want, what):
    """max|got - want| and that over max(1, max|want|), held to 2e-3."""
    if got.dtype != want.dtype or got.shape != want.shape \
            or not torch.isfinite(got).all():
        raise AssertionError(f"{what}: {got.dtype} {tuple(got.shape)} vs "
                             f"{want.dtype} {tuple(want.shape)}, or "
                             f"non-finite")
    err = (got - want).abs().max().item() if got.numel() else 0.0
    rel = err / max(1.0, want.abs().max().item()) if got.numel() else 0.0
    if rel > 2e-3:
        raise AssertionError(f"{what}: max err {err} is {rel:.3g} of "
                             f"max(1, max|y|), over 2e-3")
    return err, rel


def phase_scan_kernel(dev):
    """Kernel 7 against its plain version (y and the final state), two
    launches bit-equal, no host synchronisation in the wrapper."""
    gen = torch.Generator(device=dev).manual_seed(9)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [(8, 512, 8192, 16, bf16, True),       # falcon-mamba prefill
             (1, 16, 8192, 16, bf16, True), (1, 1000, 8192, 16, bf16, True),
             (8, 1, 8192, 16, bf16, True), (2, 300, 1024, 4, bf16, False),
             (2, 77, 8192, 16, f32, False), (1, 1000, 8192, 16, f32, True),
             (3, 64, 200, 4, f32, True),
             # the batcher's B = 1 at L = 128 and 1024; the same at Din
             # 1024 (8 lanes a channel); N = 17 and 64 in groups of 16;
             # Din no block's width divides
             (1, 128, 8192, 16, bf16, True), (1, 1024, 8192, 16, bf16, True),
             (1, 128, 1024, 16, bf16, True), (1, 1024, 1024, 16, f32, True),
             (2, 200, 2000, 17, bf16, True), (1, 700, 520, 64, f32, False),
             (4, 129, 1001, 4, bf16, True), (1, 333, 136, 4, f32, True)]
    before = _all_counts()
    err = {f32: (0.0, 0.0), bf16: (0.0, 0.0)}
    for b, l, d, n, dt, strided in cases:
        args = scan_inputs(gen, b, l, d, n, dev, dt, strided)
        y, h = mamba_scan.selective_scan(*args, return_state=True)
        wy, wh = selective_scan_ref(*args, return_state=True)
        torch.cuda.synchronize()
        what = f"selective_scan (B, L, D, N) = {(b, l, d, n)} {dt}"
        for e in (_rel_err(y, wy, what + " y"), _rel_err(h, wh, what + " hT")):
            err[dt] = (max(err[dt][0], e[0]), max(err[dt][1], e[1]))
    for b, l, d in ((BATCH, PROMPT, 8192), (1, 1024, 1024)):
        args = scan_inputs(gen, b, l, d, 16, dev, bf16, True)
        y1, h1 = mamba_scan.selective_scan(*args, return_state=True)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")     # raises on a host sync
        try:
            y2, h2 = mamba_scan.selective_scan(*args, return_state=True)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        if not (torch.equal(y1, y2) and torch.equal(h1, h2)):
            raise AssertionError(f"selective_scan at {(b, l, d, 16)}: two "
                                 f"launches differ")
    _set_counts(before)
    print(f"[9] {len(cases)} selective_scan kernel-vs-plain cases agree (y "
          f"and hT): max abs err {err[f32][0]:.3g} (f32), "
          f"{err[bf16][0]:.3g} (bf16 inputs); largest share of max(1, max|output|) "
          f"{max(err[f32][1], err[bf16][1]):.3g} (bound 2e-3); two launches "
          f"bit-equal at (8, 512, 8192, 16) and (1, 1024, 1024, 16), no host "
          f"synchronisation")
    return {"f32": err[f32][0], "bf16": err[bf16][0],
            "rel": max(err[f32][1], err[bf16][1])}


def _free():
    """Return the memory of the models the caller has just deleted."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _build_full(arch, dev):
    t0 = time.perf_counter()
    model = build_model(get_arch(arch), dev, seed=0)
    torch.cuda.synchronize()
    print(f"[{arch}] {sum(p.numel() for p in model.parameters())} parameters "
          f"initialised on the card in {time.perf_counter() - t0:.1f} s; "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    return model


def _generate_counted(cfg, model, prompts, new, max_len=MAX_LEN,
                      embeds=None):
    """Greedy tokens of one kernel-path ``generate`` and the launch counts
    of exactly that run."""
    eng = ServeEngine(cfg, max_len=max_len, params=model)
    _zero_counts()
    t0 = time.perf_counter()
    toks = eng.generate(prompts, new, embeds=embeds)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = _all_counts()
    if toks.shape != (len(prompts), new) or toks.min() < 0 or \
            toks.max() >= cfg.vocab_size:
        raise AssertionError(f"{cfg.name} generate: bad tokens {toks}")
    return toks, counts, secs


def _probe_inputs(cfg):
    """What ``throughput_probe`` draws at B = 8, 512 positions: the
    reference's ``default_rng(0)`` prompts and, for a model with embedding
    inputs, its standard-normal embeddings (None otherwise)."""
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (BATCH, PROMPT)).astype(
        np.int32)
    embeds = None
    if cfg.embed_inputs:
        embeds = rng.standard_normal((BATCH, PROMPT, cfg.d_model)).astype(
            np.float32)
    return prompts, embeds


def phase_mamba_serve(model):
    """falcon-mamba-7b's main path: generate and continuous batching at full
    width; the scan launches once per layer and prefill, never in decode."""
    cfg = model.cfg
    n_layers = cfg.n_layers
    prompts, req_prompts = _lm_workload(cfg.vocab_size)
    _, gen_counts, gen_s = _generate_counted(cfg, model, prompts, NEW)
    none = {"flash_attention": 0, "flash_decode": 0, "flash_decode_int8": 0,
            "crossbar_mxv": 0, "crossbar_mxv_int8": 0}
    _expect(gen_counts, {"selective_scan": n_layers, **none},
            f"{MAMBA_ARCH} generate")
    cb = ContinuousBatcher(cfg, n_slots=SLOTS, max_len=MAX_LEN, params=model)
    reqs = [Request(rid=i, prompt=p, max_new=NEW)
            for i, p in enumerate(req_prompts)]
    for r in reqs:
        cb.submit(r)
    _zero_counts()
    t0 = time.perf_counter()
    cb.run_until_drained()
    torch.cuda.synchronize()
    cb_s = time.perf_counter() - t0
    cb_counts = _all_counts()
    if not all(r.done and len(r.out) == NEW for r in reqs):
        raise AssertionError(f"{MAMBA_ARCH} batcher: requests unfinished")
    _expect(cb_counts, {"selective_scan": n_layers * cb.stats["prefills"],
                        **none}, f"{MAMBA_ARCH} batcher")
    if cb.stats["prefills"] != N_REQUESTS:
        raise AssertionError(f"{MAMBA_ARCH} batcher: {cb.stats}")
    print(f"[10] {MAMBA_ARCH}: generate B={BATCH} x {PROMPT} + {NEW} in "
          f"{gen_s:.2f} s, launches {gen_counts}; batcher {N_REQUESTS} "
          f"requests in {cb_s:.2f} s, {cb.stats['steps']} steps, utilization "
          f"{cb.utilization:.3f}, launches {cb_counts}")
    return {"generate": gen_counts, "batcher": cb_counts,
            "batcher_stats": dict(cb.stats)}


def phase_paths(dev, arch, model, new, bf16_bound, tag, routing=None):
    """Kernel path against plain path on the card: depth cut to 4 in f32
    (logits and greedy tokens), and ``model`` at full depth in bf16, held
    to ``bf16_bound`` or, where it is None, measured only (with the MoE
    routing of both paths put into the dict ``routing``, if given).  A
    model with embedding inputs runs on ``throughput_probe``'s inputs, an
    enc-dec's encoder cut to 4 layers too."""
    prompts, _ = _lm_workload(model.cfg.vocab_size)
    embeds = None
    if model.cfg.embed_inputs:
        prompts, embeds = _probe_inputs(model.cfg)
    over = dict(n_layers=4, param_dtype="float32", compute_dtype="float32")
    if model.cfg.is_encdec:
        over["encoder_layers"] = 4
    small = build_model(dataclasses.replace(get_arch(arch), **over), dev,
                        seed=1)
    res = {"f32_4layer": _compare_paths(small.cfg, small, prompts, 4, 2e-3,
                                        f"{arch} f32 4-layer",
                                        embeds=embeds)}
    before = _all_counts()
    toks = [ServeEngine(small.cfg, max_len=MAX_LEN, params=small,
                        use_kernel=use).generate(prompts, new, embeds=embeds)
            for use in (True, False)]
    _set_counts(before)
    if not np.array_equal(toks[0], toks[1]):
        raise AssertionError(f"{arch} f32 4-layer: greedy tokens differ "
                             f"between the kernel and plain paths")
    del small
    _free()
    res[f"bf16_{model.cfg.n_layers}layer"] = _compare_paths(
        model.cfg, model, prompts, 4,
        float("inf") if bf16_bound is None else bf16_bound,
        f"{arch} bf16 {model.cfg.n_layers}-layer", routing, embeds=embeds)
    print(f"[{tag}] {arch} kernel path vs plain path, worst |logit diff| / "
          f"max(1, max|logit|): " + ", ".join(f"{k} {v:.3g}"
                                              for k, v in res.items())
          + f" (bounds 2e-3 and "
          f"{'none: measured only' if bf16_bound is None else bf16_bound});"
          f" f32 4-layer greedy tokens equal over {toks[0].size}")
    return res


def phase_moe(dev, model):
    """qwen2-moe-a2.7b at full width: generate with exact flash launch
    counts, then kernel path against plain path."""
    cfg = model.cfg
    prompts, _ = _lm_workload(cfg.vocab_size)
    _, counts, secs = _generate_counted(cfg, model, prompts, MOE_NEW)
    _expect(counts, {"flash_attention": cfg.n_layers,
                     "flash_decode": cfg.n_layers * MOE_NEW,
                     "flash_decode_int8": 0, "selective_scan": 0},
            f"{MOE_ARCH} generate")
    print(f"[11] {MOE_ARCH}: generate B={BATCH} x {PROMPT} + {MOE_NEW} in "
          f"{secs:.2f} s, launches {counts}")
    graph = phase_graph_vs_eager(MOE_ARCH, cfg, model, prompts, MOE_NEW)
    # bf16 at full depth is measured, not held: a rounding difference in a
    # router's input can move a token to another expert, and at decode's
    # capacity of 1 token per expert that moves its neighbours too.  The
    # routing of both paths is recorded to tell the flips apart.
    routing = {}
    paths = phase_paths(dev, MOE_ARCH, model, MOE_NEW, None, 11, routing)
    print(f"[11] {MOE_ARCH} bf16 full depth, top-{cfg.moe.top_k} routing of "
          f"the kernel path against the plain path: "
          f"{routing['pairs_differing']} of {routing['pairs']} (token, "
          f"layer) pairs differ (share {routing['share_differing']:.4g}), "
          f"first in MoE layer {routing['first_layer_differing']}; "
          f"{routing['rows_agreeing']} of {routing['rows']} batch rows agree "
          f"in every layer and step, their worst |logit diff| / max(1, "
          f"max|logit|) {routing['worst_on_agreeing_rows']}")
    l0 = routing["layer0"]
    print(f"[11] {MOE_ARCH} MoE layer 0 of the prefill: {l0['flips']} of "
          f"{l0['pairs']} tokens flip; the plain path's top-"
          f"{cfg.moe.top_k} margin (k-th minus (k+1)-th probability) at the "
          f"flips: max {l0['flip_margin_max']}, median "
          f"{l0['flip_margin_median']}, against a median of "
          f"{l0['margin_median']} over every token; the largest router "
          f"probability difference between the paths {l0['prob_diff_max']}; "
          f"{l0['explained']} of {l0['flips']} flips have a margin below "
          f"that token's probability difference (explained by the inputs' "
          f"rounding), {l0['within_2x']} below twice it; the kernel path's "
          f"own margin at the flips: max {l0['kernel_margin_max']}, median "
          f"{l0['kernel_margin_median']}; {l0['both_below_own']} of "
          f"{l0['flips']} flips have both paths' margins below that token's "
          f"probability difference; {l0['near_tie']} of {l0['flips']} have "
          f"both below the median difference over the tokens that do not "
          f"flip, {l0['nonflip_diff_median']} (near-tie flips)")
    l0["parting"] = _layer0_parting(cfg, model,
                                    _lm_workload(cfg.vocab_size)[0],
                                    l0.pop("far"), l0.pop("far_probs"))
    return {"generate": counts, "generate_s": secs, "paths": paths,
            "routing": routing, "graph_vs_eager": graph}


def _bf16_steps(a, b):
    """max |a - b| in bf16 rounding steps at the tensors' scale: the step of
    a bf16 at max(|a|, |b|) over all elements, 2^(e - 7) for a magnitude in
    [2^e, 2^(e + 1)).  (An element near zero, where a step is tiny, would
    make an elementwise count meaningless.)"""
    a, b = a.float(), b.float()
    mag = max(a.abs().max().item(), b.abs().max().item(), 1e-30)
    return ((a - b).abs().max() / 2.0 ** (math.floor(math.log2(mag)) - 7)
            ).item()


def _parting_readings(a, b):
    """|a - b| of one token's tensor read three ways: in bf16 steps at the
    token's scale (``_bf16_steps``); element by element, the largest count
    of bf16 steps at each element's own magnitude (an element near zero
    counts many); and, favouring neither, the largest relative difference
    over the elements at or above 1% of the token's largest magnitude."""
    a, b = a.float(), b.float()
    mag = torch.maximum(a.abs(), b.abs())
    diff = (a - b).abs()
    step = torch.exp2(torch.floor(torch.log2(mag.clamp_min(1e-30))) - 7)
    big = mag >= 0.01 * mag.max()
    return {"scale_steps": _bf16_steps(a, b),
            "element_steps": (diff / step).max().item(),
            "rel_over_1pct": (diff[big] / mag[big]).max().item()}


def _attention_p_bf16(q, k, v, bk=64):
    """Causal attention of bf16 q, k, v (B, H, S, D) as the tensor-core
    flash kernel computes it: f32 scores, running max and sum in f32, P
    rounded to bf16 before the P.V product, tile by tile of ``bk`` keys
    (``tests/test_torch_attn.py``'s emulation, on the card)."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    dev = q.device
    kf = k.float().repeat_interleave(hq // hkv, 1)
    vf = v.float().repeat_interleave(hq // hkv, 1)
    qf = q.float() * d ** -0.5
    m = torch.full((b, hq, sq, 1), -1e30, device=dev)
    l_sum = torch.zeros((b, hq, sq, 1), device=dev)
    acc = torch.zeros((b, hq, sq, d), device=dev)
    iq = torch.arange(sq, device=dev)[:, None] + (sk - sq)
    for k0 in range(0, sk, bk):
        sc = qf @ kf[:, :, k0:k0 + bk].transpose(-1, -2)
        ik = torch.arange(k0, min(k0 + bk, sk), device=dev)[None]
        sc = torch.where(ik <= iq, sc, -torch.inf)
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        pr = torch.exp(sc - m_new)
        alpha = torch.exp(m - m_new)
        l_sum = l_sum * alpha + pr.sum(-1, keepdim=True)
        acc = acc * alpha + pr.bfloat16().float() @ vf[:, :, k0:k0 + bk]
        m = m_new
    return (acc / l_sum.clamp_min(1e-30)).bfloat16()


# layer 0's tensors from the attention on, in the order the layer makes them
LAYER0_TENSORS = ("attention output", "attention projection", "residual",
                  "router input", "router logits")


def _layer0_parting(cfg, model, prompts, far, far_probs):
    """Where layer 0's kernel path and plain path part, at the routing
    flips of MoE layer 0 that are not near ties (``far``: (row, token)
    pairs; ``far_probs``: both paths' router probabilities there, as
    recorded).  Layer 0 is recomputed both ways as ``lm._position_block``
    runs it (the same ops on the same inputs: the recorded probabilities
    must come out bit for bit), and for each flip every tensor's largest
    difference between the paths at that token, in bf16 rounding steps at
    the token's scale of that tensor (``_bf16_steps``), is reported with
    the first tensor over one step, and read two more ways
    (``_parting_readings``: element by element, and relative over the
    elements at or above 1% of the token's largest).  The
    attention output is also held against ``_attention_p_bf16``, the flash
    kernel's own arithmetic (P rounded to bf16): the kernel's distance to
    it and the plain path's."""
    from repro_torch.models import layers as lay
    dev = model.device
    tokens = torch.as_tensor(prompts, dtype=torch.int64, device=dev)
    b, s = tokens.shape
    p = model.layers[0]
    before = _all_counts()
    with torch.no_grad():
        x = model.embed[tokens]
        h = lay.apply_norm(cfg, p.norm1, x)
        pos = torch.arange(s, device=dev)[None].expand(b, s)
        q, k, v = lay._project_qkv(cfg, p.attn, h, h)
        q = lay.positional_rotate(cfg, q, pos)
        k = lay.positional_rotate(cfg, k, pos)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        emul = _attention_p_bf16(qt, kt, vt).transpose(1, 2)
        paths = {}
        for way, use in (("kernel", True), ("plain", False)):
            o = kernel_ops.attention(qt, kt, vt, causal=True,
                                     use_kernel=use).transpose(1, 2)
            y = o.reshape(b, s, -1) @ p.attn["wo"]
            x1 = x + y
            h2 = lay.apply_norm(cfg, p.norm2, x1)
            paths[way] = dict(zip(LAYER0_TENSORS, (
                o, y, x1, h2, h2.to(torch.float32) @ p.moe["router"])))
    _set_counts(before)
    rows = torch.tensor([r for r, _ in far], dtype=torch.int64, device=dev)
    cols = torch.tensor([t for _, t in far], dtype=torch.int64, device=dev)
    exact = all(torch.equal(torch.softmax(
        paths[way]["router logits"], -1)[rows, cols], want)
        for way, want in zip(("kernel", "plain"), far_probs))
    flips = []
    for (r, t) in far:
        reads = {name: _parting_readings(paths["kernel"][name][r, t],
                                         paths["plain"][name][r, t])
                 for name in LAYER0_TENSORS}
        steps = {n: x["scale_steps"] for n, x in reads.items()}
        first = next((n for n in LAYER0_TENSORS if steps[n] > 1), None)
        flips.append({
            "row": r, "token": t, "bf16_steps": steps,
            "element_steps": {n: x["element_steps"] for n, x in reads.items()},
            "rel_over_1pct": {n: x["rel_over_1pct"] for n, x in reads.items()},
            "first_over_one": first,
            "kernel_vs_emulation_steps": _bf16_steps(
                paths["kernel"]["attention output"][r, t], emul[r, t]),
            "kernel_equals_emulation": torch.equal(
                paths["kernel"]["attention output"][r, t], emul[r, t]),
            "plain_vs_emulation_steps": _bf16_steps(
                paths["plain"]["attention output"][r, t], emul[r, t])})
    out = {"recomputed_probs_bit_equal": exact, "flips": flips}
    print(f"[11] {MOE_ARCH} layer 0 at the {len(far)} flips that are not "
          f"near ties: recomputed router probabilities bit-equal to the "
          f"recorded ones: {exact}; at each (row, token), the largest "
          f"kernel-vs-plain difference in bf16 steps at the token's scale "
          f"of each tensor ("
          + ", ".join(LAYER0_TENSORS) + "), the first over one step, and "
          "the attention output's distance in steps from the flash kernel's "
          "own arithmetic (P rounded to bf16), kernel (bit-equal?) / plain: "
          + "; ".join(f"({f['row']}, {f['token']}): "
                      + " / ".join(f"{f['bf16_steps'][n]:.3g}"
                                   for n in LAYER0_TENSORS)
                      + f", first {f['first_over_one']}, "
                      f"{f['kernel_vs_emulation_steps']:.3g} "
                      f"({f['kernel_equals_emulation']}) / "
                      f"{f['plain_vs_emulation_steps']:.3g}"
                      for f in flips))
    print(f"[11] {MOE_ARCH} layer 0 at the same flips, the same tensors, "
          f"read element by element (the largest count of bf16 steps at "
          f"each element's own magnitude) / as the largest relative "
          f"difference over the elements at or above 1% of the token's "
          f"largest: "
          + "; ".join(f"({f['row']}, {f['token']}): "
                      + ", ".join(f"{f['element_steps'][n]:.3g} / "
                                  f"{f['rel_over_1pct'][n]:.3g}"
                                  for n in LAYER0_TENSORS)
                      for f in flips))
    return out


def phase_hybrid(dev):
    """jamba's smoke config (reduced width, f32) on the card: launch counts
    of each kernel, and the kernel path against the plain path."""
    from repro_torch.configs.base import smoke_config
    out = {}
    rng = np.random.default_rng(11)
    for kv in ("compute", "int8"):
        # head_dim 32: the flash kernels are built for 32, 64, 128 and 256,
        # and the smoke config's is 16
        cfg = dataclasses.replace(smoke_config(HYBRID_ARCH), kv_dtype=kv,
                                  head_dim=32)
        model = build_model(cfg, dev, seed=2)
        prompts = rng.integers(0, cfg.vocab_size, (BATCH, 100)).astype(
            np.int32)
        toks, counts, _ = _generate_counted(cfg, model, prompts, NEW)
        n_attn = cfg.n_layers // len(cfg.layer_period)   # one per period
        n_mamba = cfg.n_layers - n_attn
        dec, other = (("flash_decode", "flash_decode_int8") if kv == "compute"
                      else ("flash_decode_int8", "flash_decode"))
        _expect(counts, {"selective_scan": n_mamba, "flash_attention":
                         n_attn, dec: n_attn * NEW, other: 0},
                f"{HYBRID_ARCH} (reduced) kv={kv} generate")
        worst = _compare_paths(cfg, model, prompts, 4, 2e-3,
                               f"{HYBRID_ARCH} (reduced) kv={kv}")
        before = _all_counts()
        plain = ServeEngine(cfg, max_len=MAX_LEN, params=model,
                            use_kernel=False).generate(prompts, NEW)
        _set_counts(before)
        same = float(np.mean(plain == toks))
        # the int8 cache may flip a code at a rounding boundary (PR 12):
        # tokens held equal with the float cache only
        if kv == "compute" and same != 1.0:
            raise AssertionError(f"{HYBRID_ARCH} (reduced): greedy tokens "
                                 f"differ between the kernel and plain paths")
        out[kv] = {"launches": counts, "logit_diff": worst,
                   "tokens_equal": same,
                   "graph_vs_eager": phase_graph_vs_eager(
                       f"{HYBRID_ARCH} (reduced) kv={kv}", cfg, model,
                       prompts, NEW)}
        del model
        _free()
    print(f"[12] {HYBRID_ARCH} at its reduced smoke width (d 64, head_dim "
          f"32, 8 layers MMMMAMMM, 4 experts; 398 B parameters do not fit "
          f"one card), f32: "
          + "; ".join(f"kv={kv}: launches {r['launches']}, worst |logit "
                      f"diff| / max(1, max|logit|) {r['logit_diff']:.3g}, "
                      f"greedy tokens equal {r['tokens_equal']:.3f}"
                      for kv, r in out.items()))
    return out


# ------------------------------------------------ enc-dec and VLM families
def _attention_without(q, k, v, causal, lo, hi):
    """``attention_ref``'s arithmetic (f32, the output in q's dtype) with
    keys ``[lo, hi)`` masked out: what a flash kernel that skipped that
    tile of keys would give."""
    d, sq, sk = q.shape[-1], q.shape[2], k.shape[2]
    g = q.shape[1] // k.shape[1]
    kf, vf = (t.float().repeat_interleave(g, 1) for t in (k, v))
    sc = q.float() @ kf.transpose(-1, -2) / d ** 0.5
    ik = torch.arange(sk, device=q.device)
    keep = ((ik < lo) | (ik >= hi))[None]
    if causal:
        keep = keep & (ik[None] <= torch.arange(sq, device=q.device)[:, None]
                       + sk - sq)
    sc = torch.where(keep, sc, -torch.inf)
    return (torch.softmax(sc, -1) @ vf).to(q.dtype)


def _held_bound(name, want, v):
    """The largest difference a flash kernel's bf16 output may have from
    its plain version (f32 arithmetic, one rounding to bf16): two bf16
    steps at the output's largest value (each side rounds once; a step is
    at most 2^-7 of the value), and for flash attention twice the
    tensor-core kernel's rounding of P to bf16 before P.V (at most 2^-9 of
    each term p v, so at most 2^-9 max|V| after the division by the f32
    sum of P).  The decode kernel keeps P in f32."""
    bound = 2.0 ** -6 * want.abs().max().item()
    if name == "flash_attention":
        bound += 2.0 ** -8 * v.abs().max().item()
    return bound


class _HeldCalls:
    """While entered, holds every call the model makes of the flash kernels
    (``flash_attention``, ``flash_decode``, through ``kernels.ops``)
    against the plain version on the very same inputs, once per distinct
    (kernel, operand shapes and dtypes, causal): the served shapes, on the
    served values.  f32: phase 6's 2e-3.  bf16: phase 6's 5e-2 and
    ``_held_bound``, at the scale of the call's own output and V.  Each bf16 bound is shown to see
    a fault: the plain version with keys 64-127 dropped (flash attention
    over 128 keys or more) and with every row's length one short (flash
    decode) must miss it.  ``held`` gets {kernel: [{"shapes", "causal",
    "err", "max_want", "max_v", "bound", "fault_err"}]}.  Run it on an
    eager step: a captured one would record the plain version too."""

    def __init__(self, held):
        self.held = held
        self._orig = {}

    def _hold(self, name, out, args, causal):
        what = f"[21] {name} {[tuple(a.shape) for a in args[:3]]} " \
               f"{out.dtype} causal={causal}"
        q, k, v = args[:3]
        attn = name == "flash_attention"
        want = (flash_attn.flash_attention_plain(q, k, v, causal) if attn
                else decode_attn.flash_decode_plain(*args))
        fault_err = None
        if out.dtype == torch.float32:
            err, bound = _attn_err(out, want, 2e-3, what), 2e-3
        else:
            err = _attn_err(out, want, 5e-2, what)        # phase 6's rule
            bound = _held_bound(name, want, v)
            if err > bound:
                raise AssertionError(f"{what}: max err {err} over the bound "
                                     f"{bound}")
            fault = None                    # one tile of keys: no fault
            if not attn:
                fault = decode_attn.flash_decode_plain(q, k, v, args[3] - 1)
            elif k.shape[2] >= 128:
                fault = _attention_without(q, k, v, causal, 64, 128)
            if fault is not None:
                fault_err = (fault.float() - want.float()).abs().nan_to_num(
                    0.0).max().item()
                if fault_err <= bound:
                    raise AssertionError(
                        f"{what}: the bound {bound} would pass the fault "
                        f"({fault_err}): the check cannot see it")
        return {"shapes": [list(a.shape) for a in args
                           if isinstance(a, torch.Tensor)],
                "causal": causal, "err": err,
                "max_want": want.abs().max().item(),
                "max_v": v.abs().max().item(), "bound": bound,
                "fault_err": fault_err}

    def __enter__(self):
        for name in ("flash_attention", "flash_decode"):
            fn = getattr(kernel_ops, name)
            self._orig[name] = fn

            def held(*args, _fn=fn, _name=name, **kw):
                out = _fn(*args, **kw)
                causal = kw.get("causal")
                key = tuple((tuple(a.shape), str(a.dtype)) for a in args
                            if isinstance(a, torch.Tensor)) + (causal,)
                seen = self.held.setdefault(_name, {})
                if key not in seen:
                    seen[key] = self._hold(_name, out, args, causal)
                return out
            setattr(kernel_ops, name, held)
        return self

    def __exit__(self, *exc):
        for name, fn in self._orig.items():
            setattr(kernel_ops, name, fn)


def _family_kernel_times(dev):
    """The two served shapes no earlier path has, in bf16: flash attention
    at seamless-m4t's encoder, (B, Hq, Hkv, S, D) = (8, 16, 16, 512, 64)
    non-causal, and flash decode at qwen2-vl's heads (8, 28, 4, MAX_LEN,
    128, G = 7) with every row at ``DECODE_LENGTH``: µs per launch (CUDA
    events), device µs (torch.profiler; a decode call's two kernels'
    union), the plain version's ms, SDPA's on the same call (events and
    device; never called by the port) and the bound."""
    import torch.nn.functional as F
    gen = torch.Generator(device=dev).manual_seed(10)
    out = {}
    before = _all_counts()
    enc = get_arch(ENCDEC_ARCH)
    hq, hkv, d = enc.n_heads, enc.n_kv_heads, enc.hd
    q = torch.randn(BATCH, PROMPT, hq, d, generator=gen, device=dev)
    k, v = (torch.randn(BATCH, PROMPT, hkv, d, generator=gen, device=dev)
            for _ in range(2))
    args = tuple(t.bfloat16().transpose(1, 2) for t in (q, k, v))
    bound = _attn_bound(BATCH, hq, hkv, PROMPT, PROMPT, d, 2, causal=False)
    kern = lambda: flash_attn.flash_attention(*args, causal=False)
    lib = lambda: F.scaled_dot_product_attention(*args, enable_gqa=True)
    out["flash_attention"] = dict(
        shape=[BATCH, hq, hkv, PROMPT, PROMPT, d, "bfloat16", "non-causal"],
        ms=_events_ms(kern, reps=20, trials=5, warmup=3),
        dev_us=_device_us(kern, WGMMA_FLASH_KERNEL, reps=20, tries=3),
        plain_ms=_events_ms(lambda: flash_attn.flash_attention_plain(
            *args, False), reps=5, trials=3, warmup=1),
        lib_ms=_events_ms(lib, reps=20, trials=5, warmup=3),
        lib_dev_us=_device_total_us(
            lib, f"[21] SDPA at {ENCDEC_ARCH}'s encoder"),
        bound_ms=bound[0], bound_by=bound[1])
    vlm = get_arch(VLM_ARCH)
    hq, hkv, d = vlm.n_heads, vlm.n_kv_heads, vlm.hd
    lengths = torch.full((BATCH,), DECODE_LENGTH, dtype=torch.int32,
                         device=dev)
    q = torch.randn(BATCH, hq, d, generator=gen, device=dev).bfloat16()
    kt, vt = (torch.randn(BATCH, MAX_LEN, hkv, d, generator=gen, device=dev)
              .bfloat16().transpose(1, 2) for _ in range(2))
    mask = (torch.arange(MAX_LEN, device=dev)[None]
            < lengths[:, None].long())[:, None, None, :]
    bound = _decode_bound(BATCH, hq, hkv, MAX_LEN, d, lengths, 2, 2, False)
    kern = lambda: decode_attn.flash_decode(q, kt, vt, lengths)
    lib = lambda: F.scaled_dot_product_attention(
        q[:, :, None], kt, vt, attn_mask=mask, enable_gqa=True)
    out["flash_decode"] = dict(
        shape=[BATCH, hq, hkv, MAX_LEN, d, "bfloat16", "lengths",
               DECODE_LENGTH],
        ms=_events_ms(kern, reps=20, trials=5, warmup=3),
        dev_us=_device_total_us(kern, f"[21] flash_decode at {VLM_ARCH}'s "
                                      f"heads"),
        plain_ms=_events_ms(lambda: decode_attn.flash_decode_plain(
            q, kt, vt, lengths), reps=5, trials=3, warmup=1),
        lib_ms=_events_ms(lib, reps=20, trials=5, warmup=3),
        lib_dev_us=_device_total_us(lib, f"[21] SDPA at {VLM_ARCH}'s "
                                         f"decode heads"),
        bound_ms=bound[0], bound_by=bound[1])
    _set_counts(before)
    for name, t in out.items():
        print(f"[21] {name} at {t['shape']}: {t['ms'] * 1e3:.2f} us per "
              f"launch (events), device "
              + ("not measured" if t["dev_us"] is None
                 else f"{t['dev_us']:.2f} us")
              + f"; bound {t['bound_ms'] * 1e3:.2f} us ({t['bound_by']}); "
              f"plain {t['plain_ms']:.3f} ms; SDPA {t['lib_ms'] * 1e3:.2f} "
              f"us per call, device "
              + ("not measured" if t["lib_dev_us"] is None
                 else f"{t['lib_dev_us']:.2f} us"))
    return out


def phase_family(dev, arch):
    """An enc-dec (seamless-m4t-large-v2) or VLM (qwen2-vl-7b) model at full
    width and depth through ``ServeEngine``, on the inputs
    ``throughput_probe`` draws (B = 8, 512 prompt tokens and 512
    embeddings): one generate's launch counts held exactly (flash attention
    once per self- and cross-attention layer in prefill, the encoder's
    included; flash decode once per self- and cross-attention layer and
    step); seamless again over 16 decoder tokens (cross-attention with Sq <
    Sk); every flash call of an eager generate held against its plain
    version on its own inputs (``_HeldCalls``); phase 20's graph against
    eager; ``throughput_probe`` in turns; and phase 10's kernel path against
    plain path (4 layers in f32 at 2e-3, full depth in bf16 at
    ``BF16_LOGIT_BOUND``)."""
    model = _build_full(arch, dev)
    cfg = model.cfg
    n = cfg.n_layers
    is_encdec = cfg.is_encdec
    prompts, embeds = _probe_inputs(cfg)
    want = {"flash_attention": n + (cfg.encoder_layers + n if is_encdec
                                    else 0),
            "flash_decode": NEW * n * (2 if is_encdec else 1),
            "flash_decode_int8": 0, "selective_scan": 0, "crossbar_mxv": 0,
            "crossbar_mxv_int8": 0, "crossbar_conv2d": 0}
    out = {}
    runs = [("generate", prompts)]
    if is_encdec:
        runs.append((f"generate_{ENCDEC_SHORT}_over_{PROMPT}",
                     prompts[:, :ENCDEC_SHORT]))
    for key, p in runs:
        _, counts, secs = _generate_counted(cfg, model, p, NEW,
                                            embeds=embeds)
        _expect(counts, want, f"[21] {arch} {key}")
        out[key] = {"launches": _nonzero(counts), "s": secs}
        print(f"[21] {arch} {key}: B={BATCH}, prompt {p.shape[1]} tokens "
              f"over {embeds.shape[1]} embeddings, {NEW} new, graph step, "
              f"in {secs:.2f} s; launches {_nonzero(counts)} (exact)")
    held = {}
    eng = ServeEngine(cfg, max_len=MAX_LEN, params=model, compile=False)
    before = _all_counts()
    with _HeldCalls(held):
        for _, p in runs:
            eng.generate(p, 2, embeds=embeds)
    _set_counts(before)
    del eng
    out["held"] = {k: list(v.values()) for k, v in held.items()}
    print(f"[21] {arch}: every flash call of an eager generate against its "
          f"plain version on its own inputs, once per served shape: max abs "
          f"err, max|want|, max|V|, bound, and the fault's max abs err "
          f"(keys 64-127 dropped / lengths one short): "
          + "; ".join(f"{k} {h['shapes']} causal={h['causal']}: "
                      f"{h['err']:.4g}, {h['max_want']:.4g}, "
                      f"{h['max_v']:.4g}, {h['bound']:.4g}, "
                      + ("-" if h["fault_err"] is None
                         else f"{h['fault_err']:.4g}")
                      for k, v in out["held"].items() for h in v))
    out["graph_vs_eager"] = phase_graph_vs_eager(arch, cfg, model, prompts,
                                                 NEW, embeds=embeds)
    out["probes"] = [{"graph": c, **p} for c, p in _probe_turns(cfg, model)]
    _print_probes(21, arch, [(p["graph"], p) for p in out["probes"]])
    out["paths"] = phase_paths(dev, arch, model, NEW, BF16_LOGIT_BOUND, 21)
    del model
    _free()
    return out


def family_kernel_cells(kernels, families, times):
    """Phase 21 in the ``kernels`` line: on the flash attention and flash
    decode rows, each family generate's launches and the new served shape's
    times."""
    for row in kernels:
        name = row["name"]
        if name not in times:
            continue
        row["launches_by_path"] = {
            f"{arch} {run}": out[run]["launches"].get(name, 0)
            for arch, out in families.items() for run in out
            if run.startswith("generate")}
        t = times[name]
        row["family_shape"] = {
            "shape": t["shape"], "ms": t["ms"], "device_ms": _ms(t["dev_us"]),
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["lib_ms"],
            "library_device_ms": _ms(t["lib_dev_us"])}
        row["held_by_family"] = {arch: out["held"].get(name)
                                 for arch, out in families.items()}
        if name == "flash_attention":           # the paths' records, once
            row["families"] = {
                arch: {"probes": out["probes"],
                       "graph_vs_eager": out["graph_vs_eager"],
                       "logit_diff_kernel_vs_plain": out["paths"]}
                for arch, out in families.items()}


def _scan_bound(b, l, d, n, elem):
    """Every input read once, y and hT written once; 6 operations per
    (b, t, d, n) (dt a, the state's FMA, dt u B, the output's FMA) and 3
    per (b, t, d); the exponentials' time on the special-function units as
    an estimate beside it."""
    nbytes = (2 * b * l * d * elem + 2 * b * l * n * elem + d * n * 4 + d * 4
              + b * l * d * 4 + b * d * n * 4)
    ops = 6 * b * l * d * n + 3 * b * l * d
    t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS["f32"] * 1e3
    exp_ms = b * l * d * n / EXP_PER_S * 1e3
    return ((t_b, "bytes") if t_b >= t_o else (t_o, "operations")), exp_ms


def phase_mamba_times(dev, model):
    cfg = model.cfg
    prompts, _ = _lm_workload(cfg.vocab_size)
    before = _all_counts()
    probes = _probe_turns(cfg, model)
    profiled = _profiled_generates(cfg, model, prompts)
    engine_prefill = _device_busy(lambda: lm.prefill(
        cfg, model, torch.as_tensor(prompts, dtype=torch.int64,
                                    device=model.device), MAX_LEN))
    prefills = _bucket_prefills(model)
    wall_ms, busy_ms, n_dev = profiled["graph"][:3]
    din, n = 2 * cfg.d_model, cfg.ssm.state
    gen = torch.Generator(device=dev).manual_seed(10)
    args = scan_inputs(gen, BATCH, PROMPT, din, n, dev, torch.bfloat16, True)
    kern = lambda: mamba_scan.selective_scan(*args, return_state=True)
    ms = _events_ms(kern, reps=20, trials=5, warmup=3)
    dev_us = scan_device_us(kern)
    plain_ms = _events_ms(
        lambda: selective_scan_ref(*args, return_state=True),
        reps=2, trials=3, warmup=1)
    b1 = {}          # the batcher's single-sequence prefills
    for l in (16, 128, 512, 1024):
        a1 = scan_inputs(gen, 1, l, din, n, dev, torch.bfloat16, True)
        k1 = lambda: mamba_scan.selective_scan(*a1, return_state=True)
        b1[l] = (_events_ms(k1, reps=20, trials=5, warmup=3),
                 scan_device_us(k1))
    _set_counts(before)
    (bound, by), exp_ms = _scan_bound(BATCH, PROMPT, din, n, 2)
    _print_probes(13, MAMBA_ARCH, probes)
    _print_profiled(13, MAMBA_ARCH, profiled)
    w, b = engine_prefill[:2]
    print(f"[13] {MAMBA_ARCH} engine prefill B={BATCH} x {PROMPT} (eager), "
          f"profiled: wall {w:.2f} ms, busy {_ms_text(b)}, idle share "
          f"{_share_text(None if b is None else 1 - b / w)}")
    _print_prefills(13, MAMBA_ARCH, prefills)
    print(f"[13] selective_scan at (B, L, Din, N) = {(BATCH, PROMPT, din, n)} "
          f"bf16, strided B/C: {ms * 1e3:.2f} us per launch (events), device "
          f"{'not measured' if dev_us is None else f'{dev_us:.2f} us'}; plain "
          f"{plain_ms * 1e3:.1f} us; bound {bound * 1e3:.2f} us ({by}); "
          f"exponentials at 16 per clock per SM: an estimated "
          f"{exp_ms * 1e3:.1f} us")
    per_elem = {}
    for b, l, (e_ms, d_us) in [(BATCH, PROMPT, (ms, dev_us))] + [
            (1, l, v) for l, v in b1.items()]:
        plan = mamba_scan.scan_plan(b, l, din, n, torch.bfloat16)
        elems = b * l * din * n
        per_elem[b, l] = None if d_us is None else d_us / elems * 1e6
        print(f"[13] selective_scan (B, L) = {(b, l)}: device {_us(d_us)}, "
              f"{e_ms * 1e3:.2f} us per launch (events); "
              + ("per (b, t, d, n) element not measured" if d_us is None
                 else f"{per_elem[b, l]:.4f} ps per (b, t, d, n) element")
              + f"; plan computed by scan_plan: {plan.states} states x "
              f"{plan.lanes} lanes a channel, grid "
              f"{plan.grid}, {plan.working_warps} working warps; "
              f"exponentials' estimate {elems / EXP_PER_S * 1e6:.2f} us")
    if None not in (per_elem[BATCH, PROMPT], per_elem[1, 1024]):
        print(f"[13] selective_scan per element at B = 1, L = 1024 over "
              f"B = {BATCH} x {PROMPT}: "
              f"{per_elem[1, 1024] / per_elem[BATCH, PROMPT]:.3f}")
    return dict(probes=probes, wall_ms=wall_ms, busy_ms=busy_ms,
                profiled=_profiled_json(profiled),
                engine_prefill=_profiled_json({"eager": engine_prefill}),
                bucket_prefills=prefills,
                device_events=n_dev, ms=ms, dev_us=dev_us, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, exp_ms=exp_ms,
                shape=[BATCH, PROMPT, din, n, "bfloat16"],
                b1={l: {"ms": e_ms, "device_ms": _ms(d_us)}
                    for l, (e_ms, d_us) in b1.items()})


def scan_kernel_row(errs, serve, paths, times, moe, hybrid):
    return {
        "name": "selective_scan", "route": "cuda", "source": SCAN_SOURCE,
        "replaces": REPLACES["selective_scan"],
        "launches": serve["generate"]["selective_scan"],
        "max_abs_err": errs["f32"], "ms": times["ms"],
        "plain_ms": times["plain_ms"], "bound_ms": times["bound_ms"],
        "bound_by": times["bound_by"], "library_ms": None,
        "max_abs_err_bf16": errs["bf16"], "max_rel_err": errs["rel"],
        "shape": times["shape"],
        "device_ms": None if times["dev_us"] is None
        else times["dev_us"] / 1e3,
        "launches_batcher": serve["batcher"]["selective_scan"],
        "b1_by_prompt": times["b1"],
        "mamba": {
            "arch": MAMBA_ARCH,
            "probes": [{"graph": c, **p} for c, p in times["probes"]],
            "generate_wall_ms_profiled": times["wall_ms"],
            "generate_device_busy_ms": times["busy_ms"],
            "generate_device_events": times["device_events"],
            "generate_profiled": times["profiled"],
            "engine_prefill_profiled": times["engine_prefill"],
            "bucket_prefills": times["bucket_prefills"],
            "batcher_stats": serve["batcher_stats"],
            "graph_vs_eager": serve["graph_vs_eager"],
            "logit_diff_kernel_vs_plain": paths},
        "moe": {"arch": MOE_ARCH, **moe},
        "hybrid_reduced": {"arch": HYBRID_ARCH, **hybrid},
    }


# ------------------------------------- Listing-1 conv, faults and verifier
# ------------------------------------------------------------ phase 22: training
BWD_SOURCE = "src/repro_torch/kernels/csrc/flash_attn_bwd.cu"
ADAMW_SOURCE = "src/repro_torch/kernels/csrc/adamw.cu"
# the lr of the AdamW check: the schedule's at step 9 (2.7e-4, in its
# warm-up) moves most bf16 parameters by less than a bf16 ulp, where a
# fault in the update (bc2 or the decay left out) would mostly round away
ADAMW_CHECK_LR = 1e-2
# AdamW replaces no pallas_call: the reference's update is plain jnp, which
# XLA fuses under the train step's jax.jit
ADAMW_REPLACES = ("none; src/repro/optim/adamw.py:30 adamw_update, plain "
                  "jnp fused by XLA under the step's jax.jit")
# the backward replaces no pallas_call: it is the gradient of the reference's
# plain attention, which jax.value_and_grad differentiates
BWD_REPLACES = "none; gradient of src/repro/models/layers.py:346"
# every backward kernel, and the calls it serves (``flash_attn.bwd_kernels``)
BWD_KERNELS = {"attn_bwd_preprocess_kernel": "every call",
               "attn_bwd_dkdv_wgmma_kernel": "bf16 at D 32, 64, 128",
               "attn_bwd_dq_wgmma_kernel": "bf16 at D 32, 64, 128",
               "attn_bwd_dkdv_kernel": "f32 at D 32, 64, 128, 256; "
                                       "bf16 at D 256",
               "attn_bwd_dq_kernel": "f32 at D 32, 64, 128, 256; "
                                     "bf16 at D 256"}
# (B, Hq, Hkv, Sq, Sk, D, causal, dtype): llama's training shape in bf16 and
# f32, seamless's encoder (D 64, non-causal), gemma's 8/1 heads (D 256), D
# 32, ragged S, and 16 queries over 512 keys non-causal
BWD_SHAPES = [(8, 24, 8, 512, 512, 128, True, torch.bfloat16),
              (2, 24, 8, 512, 512, 128, True, torch.float32),
              (8, 16, 16, 512, 512, 64, False, torch.bfloat16),
              (4, 8, 1, 512, 512, 256, True, torch.bfloat16),
              (4, 8, 2, 256, 256, 32, True, torch.bfloat16),
              (4, 8, 2, 256, 256, 32, True, torch.float32),
              (2, 24, 8, 77, 77, 128, True, torch.bfloat16),
              (2, 24, 8, 77, 77, 128, True, torch.float32),
              (8, 16, 16, 16, 512, 64, False, torch.bfloat16)]
TRAIN_STEPS, TRAIN_LR = 8, 3e-3          # the launcher's default --lr
# the kernel path's step-0 gradients against the plain path's at full
# width, each parameter's relative L2 difference, and the loss's relative
# difference: the bounds PERF.md states (the gradient's shown to see a
# planted fault, ``_head0_left_out``)
GRAD_REL_L2_BOUND, LOSS_REL_BOUND = 0.1, 1e-3


def _bwd_bound(b, hq, hkv, sq, sk, d, elem, causal, products=5,
               reads=("q", "k", "v", "o", "do"), writes=("dq", "dk", "dv"),
               f32_rows=2):
    """The backward's least time: each input read and each gradient written
    once, ``f32_rows`` f32 values a query row (lse and D), and ``products``
    products of 2 d operations per unmasked (query, key) pair and head
    (five for the whole backward: S, dP, dV, dK, dQ), at the peak of the
    inputs' type."""
    off = sk - sq
    pairs = sum(min(sk, max(0, i + 1 + off)) for i in range(sq)) \
        if causal else sq * sk
    size = {"q": b * hq * sq * d, "o": b * hq * sq * d, "do": b * hq * sq * d,
            "dq": b * hq * sq * d, "k": b * hkv * sk * d, "v": b * hkv * sk * d,
            "dk": b * hkv * sk * d, "dv": b * hkv * sk * d}
    nbytes = elem * sum(size[n] for n in reads + writes) \
        + 4 * f32_rows * b * hq * sq
    ops = products * 2 * d * pairs * b * hq
    peak = PEAK_OPS["bf16" if elem == 2 else "f32"]
    t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, ops / peak * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def _bwd_inputs(shape, gen, dev):
    b, hq, hkv, sq, sk, d, causal, dt = shape
    q, do = (torch.randn(b, sq, hq, d, generator=gen, device=dev).to(dt)
             .transpose(1, 2) for _ in range(2))
    k, v = (torch.randn(b, sk, hkv, d, generator=gen, device=dev).to(dt)
            .transpose(1, 2) for _ in range(2))
    return q, k, v, do


def _bwd_limit(want, dt):
    """The bound a backward kernel's gradient is held to, against
    ``attention_bwd_ref`` on the same inputs: 2e-3 x max(1, max|g|) in f32;
    in bf16 ``_held_bound``'s rule without its P term, 2^-6 x max|g| (the
    kernel and the plain version both work in f32 and round once to bf16:
    two bf16 steps at the largest value), inside the 5e-2 x max(1, max|g|)
    of the forward's bf16 tolerance."""
    m = want.float().abs().max().item()
    return 2e-3 * max(1.0, m) if dt == torch.float32 else 2.0 ** -6 * m


def _bwd_faults(q, k, v, o, lse, do, causal):
    """``attention_bwd_ref`` with two faults a backward kernel could have,
    planted by zeroing part of dO (which drops those rows' part from every
    sum and zeroes their dq): query head 0 left out (one of the G heads of
    KV head 0's dK and dV; all of them where G = 1) and one tile of 64
    queries left out (queries 64-127, or 0-63 where Sq <= 64)."""
    from repro_torch.kernels.ref import attention_bwd_ref
    head = do.clone()
    head[:, 0] = 0
    lo = 64 if q.shape[2] > 64 else 0
    tile = do.clone()
    tile[:, :, lo:lo + 64] = 0
    return {"query head 0": attention_bwd_ref(q, k, v, o, lse, head, causal),
            f"queries {lo}-{lo + 63}": attention_bwd_ref(q, k, v, o, lse,
                                                         tile, causal)}


def phase_attention_bwd(dev):
    """Phase 22, the kernels: at every shape of ``BWD_SHAPES`` the forward's
    output with lse bit-equal to serving's (no lse), its lse within 1e-5 x
    max(1, |lse|) of ``attention_lse_ref``, and dq, dk, dv within
    ``_bwd_limit`` of ``attention_bwd_ref`` on the same o, lse and dO; each
    limit shown to see a fault: both of ``_bwd_faults`` must miss it on
    dq, dk and dv.  Prints each gradient's max|g|, limit, error and fault
    errors.  Then the times at llama's training shape, in bf16 and (at
    B = 2) in f32."""
    from repro_torch.kernels.ref import attention_bwd_ref, attention_lse_ref
    gen = torch.Generator(device=dev).manual_seed(22)
    before = _all_counts()
    err = {"f32": 0.0, "bf16": 0.0}
    lse_err = 0.0
    readings = []
    for shape in BWD_SHAPES:
        b, hq, hkv, sq, sk, d, causal, dt = shape
        q, k, v, do = _bwd_inputs(shape, gen, dev)
        o, lse = flash_attn.flash_attention_fwd(q, k, v, causal)
        if not torch.equal(o, flash_attn.flash_attention(q, k, v, causal)):
            raise AssertionError(f"[22] {shape}: the forward with lse is not "
                                 f"bit-equal to the serving call")
        _, want_lse = attention_lse_ref(q, k, v, causal)
        e = (lse - want_lse).abs().max().item()
        if not e <= 1e-5 * max(1.0, want_lse.abs().max().item()):
            raise AssertionError(f"[22] {shape}: lse off by {e}")
        lse_err = max(lse_err, e)
        got = flash_attn.flash_attention_bwd(q, k, v, o, lse, do, causal)
        want = attention_bwd_ref(q, k, v, o, lse, do, causal)
        faults = _bwd_faults(q, k, v, o, lse, do, causal)
        key = "f32" if dt == torch.float32 else "bf16"
        row = {"shape": list(shape[:-1]) + [key]}
        for i, (name, g, w) in enumerate(zip(("dq", "dk", "dv"), got, want)):
            limit = _bwd_limit(w, dt)
            e = (g.float() - w.float()).abs().max().item()
            if g.dtype != w.dtype or g.shape != w.shape or \
                    not torch.isfinite(g).all() or not e <= limit:
                raise AssertionError(f"[22] {shape} {name}: max err {e} over "
                                     f"the limit {limit}")
            miss = {f: (fw[i].float() - w.float()).abs().max().item()
                    for f, fw in faults.items()}
            if not all(m > limit for m in miss.values()):
                raise AssertionError(f"[22] {shape} {name}: the limit {limit} "
                                     f"would pass a planted fault {miss}")
            err[key] = max(err[key], e)
            row[name] = {"max_g": w.float().abs().max().item(),
                         "limit": limit, "err": e, "fault_err": miss}
        readings.append(row)
        print(f"[22] backward {row['shape']}: " + "; ".join(
            f"{n} max|g| {row[n]['max_g']:.4g}, limit {row[n]['limit']:.4g}, "
            f"err {row[n]['err']:.4g}, faults " + ", ".join(
                f"{f} {m:.4g}" for f, m in row[n]["fault_err"].items())
            for n in ("dq", "dk", "dv")))
        del got, want, faults
    torch.cuda.synchronize()
    print(f"[22] {len(BWD_SHAPES)} backward shapes agree with "
          f"attention_bwd_ref: max abs err {err['f32']:.3g} (f32), "
          f"{err['bf16']:.3g} (bf16); lse {lse_err:.3g}; every limit missed "
          f"by both planted faults")
    times = {shape[-1]: _bwd_times(shape, gen, dev)
             for shape in BWD_SHAPES[:2]}
    _set_counts(before)                # checking launches do not count
    return {"err": err, "lse_err": lse_err, "readings": readings,
            "times": times}


def _bwd_times(shape, gen, dev):
    """At ``shape``: the forward with lse's device µs and µs per launch
    (CUDA events), then the backward call's µs (events), the device µs of
    each kernel the call launches (``flash_attn.bwd_kernels``) and the
    call's (``_device_total_us``), the plain version's
    ms, SDPA's backward (autograd of ``scaled_dot_product_attention(...,
    enable_gqa=True)``: events, and ``_device_total_us`` from profiles that
    kept every event, else None) and the bound."""
    import torch.nn.functional as F
    from repro_torch.kernels.ref import attention_bwd_ref
    b, hq, hkv, sq, sk, d, causal, dt = shape
    q, k, v, do = _bwd_inputs(shape, gen, dev)
    o, lse = flash_attn.flash_attention_fwd(q, k, v, causal)
    elem = q.element_size()
    dkdv, dq, _ = flash_attn.bwd_kernels(dt, d)
    fwd = lambda: flash_attn.flash_attention_fwd(q, k, v, causal)
    call = lambda: flash_attn.flash_attention_bwd(q, k, v, o, lse, do, causal)
    out = {"shape": [b, hq, hkv, sq, sk, d, "causal" if causal else
                     "non-causal", str(dt).split(".")[-1]],
           "fwd_lse_dev_us": _device_us(
               fwd, WGMMA_FLASH_KERNEL if elem == 2 else F32_FLASH_KERNEL,
               reps=20, tries=3),
           "fwd_lse_ms": _events_ms(fwd, reps=20, trials=5, warmup=3),
           "ms": _events_ms(call, reps=10, trials=5, warmup=2),
           "dev_us": {n: _device_us(call, n, reps=10, tries=3)
                      for n in ("attn_bwd_preprocess_kernel", dkdv, dq)},
           "call_dev_us": _device_total_us(
               call, f"[22] backward call at {shape[3:6]} {shape[-1]}",
               reps=10, whole=True),
           "plain_ms": _events_ms(lambda: attention_bwd_ref(
               q, k, v, o, lse, do, causal), reps=3, trials=3, warmup=1)}
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    ref_out = F.scaled_dot_product_attention(*leaves, is_causal=causal,
                                             enable_gqa=True)
    lib = lambda: torch.autograd.grad(ref_out, leaves, do, retain_graph=True)
    out["lib_ms"] = _events_ms(lib, reps=10, trials=5, warmup=2)
    out["lib_dev_us"] = _device_total_us(
        lib, f"[22] SDPA backward at {shape[3:6]} {shape[-1]}", reps=10,
        whole=True)
    bound = _bwd_bound(b, hq, hkv, sq, sk, d, elem, causal)
    parts = {"attn_bwd_preprocess_kernel": _bwd_bound(
                 b, hq, hkv, sq, sk, d, elem, causal, 0, ("o", "do"), (), 1),
             dkdv: _bwd_bound(
                 b, hq, hkv, sq, sk, d, elem, causal, 4,
                 ("q", "k", "v", "do"), ("dk", "dv")),
             dq: _bwd_bound(
                 b, hq, hkv, sq, sk, d, elem, causal, 3,
                 ("q", "k", "v", "do"), ("dq",))}
    out.update(bound_ms=bound[0], bound_by=bound[1], kernel_bounds=parts)
    print(f"[22] backward at {out['shape']}: {out['ms'] * 1e3:.2f} us per "
          f"call (events), device {_us(out['call_dev_us'])} ("
          + ", ".join(f"{n} {_us(u)}" for n, u in out["dev_us"].items())
          + f"); bound {bound[0] * 1e3:.2f} us ({bound[1]}); plain "
          f"{out['plain_ms']:.3f} ms; SDPA backward {out['lib_ms'] * 1e3:.2f} "
          f"us per call, device {_us(out['lib_dev_us'])}; forward with lse "
          f"{out['fwd_lse_ms'] * 1e3:.2f} us per launch, device "
          f"{_us(out['fwd_lse_dev_us'])}")
    return out


def _grads(cfg, model, batch, use_kernel):
    """(loss, {name: gradient}) of one loss and backward."""
    for p in model.parameters():
        p.grad = None
    loss, _ = port_models.loss(cfg, model, batch, use_kernel)
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    for p in model.parameters():
        p.grad = None
    return loss.item(), grads


@contextlib.contextmanager
def _head0_left_out():
    """While entered, the backward kernels leave query head 0's part out of
    dK and dV (one of the G heads of KV head 0): a fault the full-width
    gradient check must see.  dq is the kernels' own; dK and dV come from a
    second launch on dO with head 0 zeroed."""
    bwd = flash_attn.flash_attention_bwd

    def faulted(q, k, v, o, lse, do, causal=True):
        dq, _, _ = bwd(q, k, v, o, lse, do, causal)
        do0 = do.clone()
        do0[:, 0] = 0
        _, dk, dv = bwd(q, k, v, o, lse, do0, causal)
        return dq, dk, dv
    flash_attn.flash_attention_bwd = faulted
    try:
        yield
    finally:
        flash_attn.flash_attention_bwd = bwd


def _rel_l2(got, want):
    """{parameter: relative L2 difference of ``got`` from ``want``}."""
    return {k: ((got[k].float() - want[k].float()).norm()
                / want[k].float().norm().clamp_min(1e-30)).item()
            for k in want}


def phase_train_full(dev):
    """Phase 22, the main path: llama3.2-3b at full width and depth trained
    by ``Trainer`` (B = 8 x 512, synthetic data from seed 0, ``TRAIN_LR``,
    no checkpoint).  First the step-0 loss and every parameter's gradient,
    kernel path against ``use_kernel=False`` on the same batch (relative L2
    per parameter within ``GRAD_REL_L2_BOUND``, the loss within
    ``LOSS_REL_BOUND``), with the kernel path's flash launches exact (56
    forward with remat, 28 backward), and the bound shown to see a fault:
    with query head 0 left out of the kernels' dK and dV
    (``_head0_left_out``) the largest relative L2 must miss it; then
    ``TRAIN_STEPS`` eager steps of ``Trainer.run`` (``compile=False``),
    counts zeroed just before: each step's loss (finite), grad norm, ms
    (CUDA events), tokens/s and peak allocated memory, the launches exactly
    ``TRAIN_STEPS`` x (56, 28, 1 AdamW), one more step profiled; the AdamW
    kernels against their plain version on that state (``_adamw_check``).
    Then the main path: a new ``Trainer`` from the same init, captured by
    default (``WARMUP_STEPS`` eager steps, a capture, replays), counts
    zeroed just before and exact after, its losses, grad norms and final
    parameters bit-equal to the eager run's and its moments' bits
    (``_bits_checksum``) the same; its capture ms and peak, and one
    replay profiled."""
    cfg = get_arch(LM_ARCH)
    tr = Trainer(cfg=cfg, batch=BATCH, seq_len=PROMPT, peak_lr=TRAIN_LR,
                 device=dev, compile=False)
    t0 = time.perf_counter()
    state = tr.init_state()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in state.model.parameters())
    print(f"[22] {LM_ARCH}: {n_params} trainable parameters and their f32 "
          f"moments on the card in {time.perf_counter() - t0:.1f} s; "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    batch = to_device(SyntheticLMData(cfg.vocab_size, BATCH, PROMPT,
                                      tr.seed).next(), dev)
    n = cfg.n_layers
    before = _all_counts()
    loss_p, plain = _grads(cfg, state.model, batch, False)
    plain = {k: g.clone() for k, g in plain.items()}
    _zero_counts()
    loss_k, kern = _grads(cfg, state.model, batch, True)
    step_counts = _nonzero(_all_counts())
    _expect(_all_counts(), {"flash_attention": 2 * n,
                            "flash_attention_bwd": n},
            f"[22] {LM_ARCH} one kernel-path step")
    rel = _rel_l2(kern, plain)
    finite = all(torch.isfinite(g).all() for g in kern.values())
    del kern
    _free()
    with _head0_left_out():
        _, fault = _grads(cfg, state.model, batch, True)
        fault_rel = _rel_l2(fault, plain)
    del fault
    _free()
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    worst = sorted(rel.items(), key=lambda kv: -kv[1])[:5]
    fault_worst = sorted(fault_rel.items(), key=lambda kv: -kv[1])[:5]
    print(f"[22] step 0, kernel path against plain path: loss {loss_k:.6f} "
          f"against {loss_p:.6f} (relative {loss_rel:.3g}, bound "
          f"{LOSS_REL_BOUND}); gradients' relative L2 over {len(rel)} "
          f"parameters: max {worst[0][1]:.4g}, median "
          f"{statistics.median(rel.values()):.4g}, bound "
          f"{GRAD_REL_L2_BOUND}; worst "
          + ", ".join(f"{k} {v:.4g}" for k, v in worst)
          + f"; launches {step_counts}")
    print(f"[22] step 0 with query head 0 left out of the kernels' dK and "
          f"dV: gradients' relative L2 max {fault_worst[0][1]:.4g}, median "
          f"{statistics.median(fault_rel.values()):.4g}; worst "
          + ", ".join(f"{k} {v:.4g}" for k, v in fault_worst))
    if not (loss_rel <= LOSS_REL_BOUND and worst[0][1] <= GRAD_REL_L2_BOUND
            and finite):
        raise AssertionError("[22] the kernel path's step-0 loss or "
                             "gradients are off the plain path's")
    if not fault_worst[0][1] > GRAD_REL_L2_BOUND:
        raise AssertionError(f"[22] the bound {GRAD_REL_L2_BOUND} would pass "
                             f"the planted fault ({fault_worst[0][1]})")
    del plain
    _free()
    _set_counts(before)
    per_step = {"flash_attention": 2 * n, "flash_attention_bwd": n,
                "adamw": 1}
    route = flash_attn.bwd_kernels(getattr(torch, cfg.compute_dtype),
                                   cfg.hd)[:2]
    eager = _train_run("eager", tr, state, per_step)
    eager["profiled_step"] = _profiled_route(tr, eager["state"], route)
    adamw = _adamw_check(tr, eager.pop("state"))
    final = eager.pop("final")
    del state, tr
    _free()
    tr = Trainer(cfg=cfg, batch=BATCH, seq_len=PROMPT, peak_lr=TRAIN_LR,
                 device=dev)
    state = tr.init_state()
    captured = _train_run("captured", tr, state, per_step)
    if captured["replayed"] != [False] * 2 + [True] * (TRAIN_STEPS - 2):
        raise AssertionError(f"[22] the captured run replayed "
                             f"{captured['replayed']}")
    same = {k: captured[k] == eager[k] for k in ("losses", "grad_norms")}
    got = captured.pop("final")
    same["params"] = all(torch.equal(got["params"][k], v)
                         for k, v in final["params"].items())
    same["moments_checksum"] = got["moments"] == final["moments"]
    print(f"[22] {LM_ARCH} {TRAIN_STEPS} captured steps against "
          f"{TRAIN_STEPS} eager steps from one init: bit-equal {same} "
          f"(moments: checksum of their bits {got['moments']}); capture "
          f"{tr.graph.capture_ms:.0f} ms, its peak "
          f"{tr.graph.peak_bytes / 2**30:.2f} GiB")
    if not all(same.values()):
        raise AssertionError(f"[22] captured and eager steps differ: {same}"
                             f"; losses {captured['losses']} against "
                             f"{eager['losses']}, grad norms "
                             f"{captured['grad_norms']} against "
                             f"{eager['grad_norms']}")
    captured["capture_ms"] = tr.graph.capture_ms
    captured["profiled_step"] = _profiled_route(tr, captured.pop("state"),
                                                route)
    del final, got
    out = {"arch": LM_ARCH, "batch": BATCH, "seq_len": PROMPT,
           "bwd_kernels": route, "lr": TRAIN_LR, "params": n_params,
           "launches": captured["launches"], "eager": eager,
           "captured": captured, "bit_equal": same, "adamw": adamw,
           "step0": {
               "loss_kernel": loss_k, "loss_plain": loss_p,
               "loss_rel": loss_rel, "grad_rel_l2_max": worst[0][1],
               "grad_rel_l2_median": statistics.median(rel.values()),
               "worst": worst, "fault_grad_rel_l2_max": fault_worst[0][1],
               "fault_worst": fault_worst}}
    del state, tr
    _free()
    return out


def _bits_checksum(tensors):
    """(sum, sum of squares) of every tensor's bits as int64, wrapping: a
    checksum of the bits."""
    s1 = s2 = 0
    for t in tensors:
        b = t.view(torch.int16 if t.element_size() == 2 else torch.int32)
        for part in b.reshape(-1).split(1 << 26):
            w = part.to(torch.int64)
            s1 += int(w.sum())
            s2 += int((w * w).sum())
    return [s1 % 2**64, s2 % 2**64]


def _train_run(kind, tr, state, per_step):
    """Phase 22: ``TRAIN_STEPS`` steps of ``tr.run`` on llama3.2-3b (the
    captured step by default, ``compile=False`` eager), the counts zeroed
    just before and exactly ``TRAIN_STEPS`` x ``per_step`` after: each
    step's loss (finite), grad norm, ms (CUDA events), tokens/s, peak
    allocated memory and whether it was a replay; the final parameters
    (copies on the host, out of the next run's device memory) and a
    checksum of the moments' bits, for the comparison."""
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    state = tr.run(TRAIN_STEPS, state=state)
    counts = _nonzero(_all_counts())
    _expect(_all_counts(), {k: v * TRAIN_STEPS for k, v in per_step.items()},
            f"[22] {LM_ARCH} {TRAIN_STEPS} {kind} steps of Trainer.run")
    if not all(math.isfinite(x) for x in tr.history):
        raise AssertionError(f"[22] non-finite losses {tr.history}")
    tokens = BATCH * PROMPT
    for i, (loss, ms, peak, rep) in enumerate(zip(
            tr.history, tr.step_ms, tr.peak_bytes, tr.replayed)):
        print(f"[22] {LM_ARCH} {kind} step {i}{' (replay)' if rep else ''}: "
              f"loss {loss:.4f}, grad norm {tr.grad_norms[i]:.4f}, "
              f"{ms:.1f} ms (CUDA events), {tokens / ms * 1e3:.0f} "
              f"tokens/s, peak allocated {peak / 2**30:.2f} GiB")
    print(f"[22] {LM_ARCH} {TRAIN_STEPS} {kind} steps: launches {counts} "
          f"(exact)")
    final = {"params": {n: p.detach().to("cpu", copy=True)
                        for n, p in state.model.named_parameters()},
             "moments": _bits_checksum(list(state.opt.mu.values())
                                       + list(state.opt.nu.values()))}
    return {"losses": list(tr.history), "grad_norms": list(tr.grad_norms),
            "step_ms": list(tr.step_ms),
            "peak_gib": [p / 2**30 for p in tr.peak_bytes],
            "replayed": list(tr.replayed), "launches": counts,
            "state": state, "final": final}


def _profiled_route(tr, state, route):
    """One more step profiled (``_train_step_profile``); the backward
    kernels it shows must be the route's."""
    profiled = _train_step_profile(tr, state)
    seen = set(profiled["bwd_kernels"]) if profiled else set(route)
    if seen != set(route):
        raise AssertionError(f"[22] the profiled step ran the backward "
                             f"kernels {sorted(seen)}, not {route}")
    return profiled


def _adamw_bound_ms(ps, gs, ms):
    """The AdamW call's bytes bound: the update reads g, p, m, v and writes
    p, m, v; the norm reads g once more."""
    total = sum(p.numel() * (2 * p.element_size() + 4 * m.element_size()
                             + (2 * g.element_size() if g is not None else 0))
                for p, g, m in zip(ps, gs, ms))
    return total / HBM_BYTES_PER_S * 1e3


def _adamw_check(tr, state):
    """Phase 22: the AdamW kernels against their plain version over
    llama3.2-3b's whole tree (254 tensors, bf16 parameters and gradients,
    f32 moments), on the eager run's trained parameters and moments and
    the gradients of one more batch, with the next step's bias corrections
    and lr ``ADAMW_CHECK_LR``.  The norm within 1e-6 relative of the
    plain version's; then, given the kernels' norm, every element of p, m
    and v bit-equal to the plain version's (both round each operation
    once, in one order: ``kernels/adamw.py``), a comparison that the plain
    version with bc2 left out, and with weight decay left out, must each
    fail on some elements of p.  Then the call's
    time (events and device time of its kernels, the update and the norm
    apart), the plain version's, and the bytes bound.  Launches made here
    are not counted."""
    dev = tr.device
    model, cfg = state.model, state.model.cfg
    params = dict(model.named_parameters())
    names = list(params)
    dec = decayed(model)
    with launches_apart({}):
        batch = to_device(tr.data.next(), dev)
        for p in params.values():
            p.grad = None
        loss, _ = port_models.loss(cfg, model, batch)
        loss.backward()
    gs = [params[n].grad for n in names]
    for p in params.values():
        p.grad = None
    del loss, batch
    ps = [params[n].detach() for n in names]
    mus = [state.opt.mu[n] for n in names]
    nus = [state.opt.nu[n] for n in names]
    decs = [dec[n] for n in names]
    hyper = torch.tensor(hyper_values(state.opt.count + 1, ADAMW_CHECK_LR),
                         device=dev)
    t0 = time.perf_counter()
    host = [tuple(t.to("cpu", copy=True) for t in ts)
            for ts in zip(ps, mus, nus)]
    copy_s = time.perf_counter() - t0
    with launches_apart({}):
        gnorm_t = kadamw.adamw_step(ps, gs, mus, nus, decs, hyper).clone()
    gnorm = gnorm_t.item()
    gnorm_plain = kadamw.global_norm_ref(gs)
    # the elements are held given the kernels' own norm, the norm apart
    scale = kadamw.clip_scale_ref(gnorm_t, 1.0)
    lr, bc1, bc2 = hyper[0], hyper[1], hyper[2]
    one = torch.ones_like(bc2)
    # a fault planted in the plain version, and the elements of p it moves
    faults = {"bc2 left out": 0, "weight decay left out": 0}
    max_abs, equal, total = 0.0, 0, 0
    for i, (p, g, m, v) in enumerate(zip(ps, gs, mus, nus)):
        p0, m0, v0 = (t.to(dev) for t in host[i])
        kw = dict(b1=0.9, b2=0.95, eps=1e-8, wd=0.1 if decs[i] else 0.0)
        p32, m32, v32 = kadamw.update_ref(p0, g, m0, v0, scale, lr, bc1, bc2,
                                          **kw)
        for got, want in ((p, p32), (m, m32), (v, v32)):
            want = want.to(got.dtype)
            max_abs = max(max_abs, (got.float() - want.float()).abs().max()
                          .item())
            equal += int((got == want).sum())
            total += got.numel()
        for fault, args, fkw in (
                ("bc2 left out", (scale, lr, bc1, one), kw),
                ("weight decay left out", (scale, lr, bc1, bc2),
                 {**kw, "wd": 0.0})):
            fp = kadamw.update_ref(p0, g, m0, v0, *args, **fkw)[0]
            faults[fault] += int((p != fp.to(p.dtype)).sum())
        del p0, m0, v0, p32, m32, v32, fp
    norm_rel = abs(gnorm - gnorm_plain.item()) / gnorm_plain.item()
    print(f"[22] AdamW kernels against the plain version over {LM_ARCH}'s "
          f"{len(ps)} tensors ({sum(p.numel() for p in ps)} parameters, "
          f"{ps[0].dtype} with {mus[0].dtype} moments): norm {gnorm:.6f} "
          f"against {gnorm_plain.item():.6f} (relative {norm_rel:.3g}, bound "
          f"1e-6); {equal} of {total} elements of p, m and v bit-equal "
          f"(required: all), max |difference| {max_abs:.3g}; the plain "
          f"version with a fault planted moves "
          + ", ".join(f"{n} {k}" for k, n in faults.items())
          + f" elements of p off the kernels' (required: some); host copy "
          f"{copy_s:.1f} s")
    if not (norm_rel <= 1e-6 and equal == total):
        raise AssertionError(f"[22] the AdamW kernels are off their plain "
                             f"version: norm {norm_rel}, {total - equal} "
                             f"elements differ")
    if not all(faults.values()):
        raise AssertionError(f"[22] the AdamW comparison would pass a planted "
                             f"fault: {faults}")
    del host
    _free()

    def call():
        kadamw.adamw_step(ps, gs, mus, nus, decs, hyper)

    with launches_apart({}):
        ms = _events_ms(call, reps=5, trials=3, warmup=1)
        dev_us = {}
        for k in ("adamw_", "adamw_update_kernel", "adamw_norm_kernel"):
            # a profile now and then records no kernel: up to 3 profiles
            for _ in range(3):
                dev_us[k] = scan_device_us(call, reps=5, match=k)
                if dev_us[k] is not None:
                    break
        plain_ms = _events_ms(lambda: kadamw.adamw_step_ref(
            ps, gs, mus, nus, decs, hyper), reps=1, trials=2, warmup=1)
    bound_ms = _adamw_bound_ms(ps, gs, mus)
    dev_text = {k: "not measured" if us is None else f"{us / 1e3:.3f} ms"
                for k, us in dev_us.items()}
    print(f"[22] AdamW over {LM_ARCH}'s tree: {ms:.3f} ms a call (CUDA "
          f"events), device {dev_text['adamw_']} (update "
          f"{dev_text['adamw_update_kernel']}, norm "
          f"{dev_text['adamw_norm_kernel']}); plain version "
          f"{plain_ms:.1f} ms; bound {bound_ms:.3f} ms (bytes); library: "
          f"none (torch.optim.AdamW keeps its moments in the parameter's "
          f"dtype and has no global-norm clip)")
    del gs
    return {"tensors": len(ps), "parameters": sum(p.numel() for p in ps),
            "norm": gnorm, "norm_plain": gnorm_plain.item(),
            "norm_rel": norm_rel, "bit_equal_elements": equal,
            "elements": total, "max_abs_err": max_abs,
            "fault_elements_moved": faults,
            "ms": ms, "device_us": dev_us, "plain_ms": plain_ms,
            "bound_ms": bound_ms}


def _train_step_profile(tr, state):
    """One more ``Trainer`` step under torch.profiler, device activity only
    (``launch.train_step_times.profile_ms``: its wall ms, the device's busy
    ms and idle share, each part of the step's device ms, the kernels with
    the most device time), and the flash backward kernels it ran."""
    prof = profile_ms(lambda: tr.run(1, state=state), cpu=False)
    names = prof.pop("kernel_names")
    if not prof["device_events"]:
        print("[22] the profiled step shows no device events")
        return None
    bwd = sorted({n for n in BWD_KERNELS if n != "attn_bwd_preprocess_kernel"
                  and any(n in name for name in names)})
    kind = "replayed" if tr.replayed[-1] else "eager"
    print(f"[22] one profiled {kind} step: wall {prof['wall_ms']:.1f} ms, "
          f"device busy {prof['busy_ms']:.1f} ms, idle share "
          f"{prof['idle_share']:.4f}; device ms by part: "
          + ", ".join(f"{k} {v:.1f}" for k, v in prof["parts_ms"].items())
          + "; top kernels: " + "; ".join(
              f"{n[:70]} {ms:.1f}" for n, ms in prof["top_kernels_ms"][:12]))
    return {**prof, "replayed": tr.replayed[-1], "bwd_kernels": bwd}


def _kill_and_resume(tag, kw):
    """``Trainer(**kw)`` run 20 steps, checkpointing every 5; another
    killed at step 12 and resumed from its step-10 checkpoint: the
    resumed 10 losses must equal the uninterrupted run's bit for bit."""
    root = pathlib.Path(__file__).resolve().parent / "build"
    root.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        tr_a = Trainer(ckpt_dir=f"{tmp}/a", **kw)
        tr_a.run(20)
        tr_b = Trainer(ckpt_dir=f"{tmp}/b", **kw)
        try:
            tr_b.run(20, die_at=12)
            raise AssertionError(f"{tag}: die_at=12 did not stop the run")
        except RuntimeError as e:
            if "injected failure" not in str(e):
                raise
        tr_c = Trainer(ckpt_dir=f"{tmp}/b", **kw)
        state = tr_c.resume_or_init()
        if (state.step, tr_c.data.step) != (10, 10):
            raise AssertionError(f"{tag}: resumed at step {state.step}, "
                                 f"data {tr_c.data.step}")
        tr_c.run(10, state=state)
    if tr_c.history != tr_a.history[10:20]:
        raise AssertionError(f"{tag}: resumed losses {tr_c.history} differ "
                             f"from {tr_a.history[10:20]}")


def phase_train_smoke(dev):
    """Phase 22 at the smoke width, f32, head_dim 32 on the card (the smoke
    config's 16 is not a built head dim), the captured step (the
    default): 40 steps at ``peak_lr=1e-2``
    whose loss falls as ``tests/test_train.py::test_loss_decreases``
    requires (the mean of the last five below that of the first five less
    0.2), and a run killed at step 12 and resumed from its step-10
    checkpoint, whose losses equal the uninterrupted run's bit for bit
    (the resumed model captured anew)."""
    cfg = dataclasses.replace(smoke_config(LM_ARCH), head_dim=32)
    kw = dict(cfg=cfg, batch=8, seq_len=32, peak_lr=1e-2, device=dev,
              ckpt_every=5)
    _zero_counts()
    tr = Trainer(**kw)
    tr.run(40)
    counts = _nonzero(_all_counts())
    n = cfg.n_layers * 40
    _expect(_all_counts(), {"flash_attention": 2 * n,
                            "flash_attention_bwd": n, "adamw": 40},
            "[22] smoke-width training")
    if tr.replayed != [False] * 2 + [True] * 38:
        raise AssertionError(f"[22] smoke width replayed {tr.replayed}")
    first, last = np.mean(tr.history[:5]), np.mean(tr.history[-5:])
    if not last < first - 0.2:
        raise AssertionError(f"[22] smoke-width loss {first} -> {last}")
    _kill_and_resume("[22] smoke width", kw)
    print(f"[22] smoke width (d {cfg.d_model}, head_dim 32, f32) on the "
          f"card: 40 steps (2 eager, then replays of one capture), loss "
          f"{first:.4f} -> {last:.4f} (mean of the "
          f"first and last five); launches {counts}; killed at 12, resumed "
          f"from step 10: the 10 losses equal the uninterrupted run's bit "
          f"for bit")
    return {"losses": tr.history, "launches": counts,
            "bwd_kernels": flash_attn.bwd_kernels(
                getattr(torch, cfg.compute_dtype), cfg.hd)[:2],
            "resumed_equal": True}


def train_kernel_rows(bwd, full, smoke):
    """Phase 22 in the ``kernels`` line: every backward kernel, each with
    the calls it serves, timed at llama's training shape in the dtype that
    routes to it (bf16 for the preprocess and the tensor-core pair, f32 at
    B = 2 for the CUDA-core pair), and its launches on the path that runs
    it: the full-width run (bf16, D 128) for the preprocess and the
    tensor-core pair, the smoke-width run (f32, head_dim 32) for the
    CUDA-core pair; both paths' counts beside.  Fails if a kernel was
    launched on neither.  The first row also carries each shape's limits,
    errors and fault errors."""
    t16, t32 = bwd["times"][torch.bfloat16], bwd["times"][torch.float32]
    n_full = full["launches"].get("flash_attention_bwd", 0)
    n_smoke = smoke["launches"].get("flash_attention_bwd", 0)
    rows = []
    for name, serves in BWD_KERNELS.items():
        t = t16 if name in t16["dev_us"] else t32
        by_path = {
            "full_width": n_full if name in full["bwd_kernels"] or
            name == "attn_bwd_preprocess_kernel" else 0,
            "smoke_width": n_smoke if name in smoke["bwd_kernels"] or
            name == "attn_bwd_preprocess_kernel" else 0}
        if not any(by_path.values()):
            raise AssertionError(f"[22] {name} was launched on no path")
        rows.append({
            "name": name, "route": "cuda", "source": BWD_SOURCE,
            "replaces": BWD_REPLACES, "serves": serves,
            "launches": by_path["full_width"] or by_path["smoke_width"],
            "launches_by_path": by_path,
            "max_abs_err": bwd["err"]["f32"],
            "max_abs_err_bf16": bwd["err"]["bf16"],
            "ms": _ms(t["dev_us"][name]), "plain_ms": t["plain_ms"],
            "bound_ms": t["kernel_bounds"][name][0],
            "bound_by": t["kernel_bounds"][name][1],
            "library_ms": t["lib_ms"],
            "library_device_ms": _ms(t["lib_dev_us"]), "shape": t["shape"],
            "call": {"ms": t["ms"], "device_ms": _ms(t["call_dev_us"]),
                     "bound_ms": t["bound_ms"], "bound_by": t["bound_by"]}})
    rows[0]["f32"] = {"shape": t32["shape"], "device_ms": _ms(
        t32["dev_us"]["attn_bwd_preprocess_kernel"]), "call_device_ms": _ms(
        t32["call_dev_us"]), "bound_ms": t32["bound_ms"],
        "library_ms": t32["lib_ms"], "library_device_ms": _ms(
            t32["lib_dev_us"])}
    rows[0]["checks"] = bwd["readings"]
    rows[0]["training"] = full
    rows[0]["training_smoke"] = smoke
    return rows


def adamw_kernel_row(full, smoke):
    """Phase 22's AdamW in the ``kernels`` line: one wrapper call a step
    (``kadamw.KERNELS``), timed over llama3.2-3b's tree; its launches on the
    main path (the captured full-width run), beside the eager run's and the
    smoke width's."""
    a = full["adamw"]
    by_path = {"full_width_captured": full["captured"]["launches"].get(
        "adamw", 0), "full_width_eager": full["eager"]["launches"].get(
        "adamw", 0), "smoke_width": smoke["launches"].get("adamw", 0)}
    if not all(by_path.values()):
        raise AssertionError(f"[22] adamw launches {by_path}")
    dev_ms = _ms(a["device_us"]["adamw_"])
    return {"name": "adamw", "route": "cuda", "source": ADAMW_SOURCE,
            "replaces": ADAMW_REPLACES, "launches": by_path[
                "full_width_captured"], "launches_by_path": by_path,
            "max_abs_err": a["max_abs_err"],
            "ms": a["ms"] if dev_ms is None else dev_ms,
            "ms_is": "events" if dev_ms is None else "device",
            "events_ms": a["ms"], "plain_ms": a["plain_ms"],
            "bound_ms": a["bound_ms"], "bound_by": "bytes",
            "library_ms": None,
            "kernels_device_ms": {k: _ms(v) for k, v in
                                  a["device_us"].items()},
            "checks": {k: v for k, v in a.items()
                       if k not in ("device_us", "ms", "plain_ms")}}


# ------------------------------------------- phase 23: every family trains
SCAN_BWD_SOURCE = "src/repro_torch/kernels/csrc/mamba_scan_bwd.cu"
# the scan's backward replaces no pallas_call: it is the gradient of the
# reference's plain chunked scan, which jax.value_and_grad differentiates
SCAN_BWD_REPLACES = "none; gradient of src/repro/models/layers.py:680"
# the reverse walk's resident warps an SM, at least (phase 1)
SCAN_BWD_MIN_WARPS = 16
# (B, L, Din, N, dtype, B/C strided, u/dt rows off 16-byte alignment):
# falcon-mamba's training shape in bf16 and f32, N of 4, 17 and 64, L = 1,
# 77 and 1000, B = 1 at Din 1024, a Din no block's width divides, u/dt rows
# of 301 elements, and jamba's smoke width in f32
SCAN_BWD_SHAPES = [(8, 512, 8192, 16, torch.bfloat16, True, False),
                   (2, 512, 8192, 16, torch.float32, True, False),
                   (2, 300, 1024, 4, torch.bfloat16, True, False),
                   (2, 200, 2000, 17, torch.bfloat16, True, False),
                   (1, 700, 520, 64, torch.float32, False, False),
                   (2, 1, 8192, 16, torch.bfloat16, True, False),
                   (2, 77, 1024, 16, torch.float32, True, False),
                   (1, 1000, 1024, 16, torch.bfloat16, True, False),
                   (4, 129, 1001, 16, torch.bfloat16, True, False),
                   (2, 64, 300, 16, torch.bfloat16, True, True),
                   (8, 32, 128, 4, torch.float32, True, False)]
SCAN_GRADS = ("du", "ddt", "dA", "dB", "dC", "dD")
# the gradients each planted fault reaches (dC = sum dy h and dD = sum dy u
# take no g and no ddt term)
SCAN_FAULT_REACH = {"carry": ("du", "ddt", "dA", "dB"), "A a h": ("ddt",)}
# the trained depths of the full-width runs (what fits one card, PERF.md),
# the depth and batch of falcon-mamba's step-0 check against the plain
# chunked scan (its autograd holds ~64 GB a layer at B = 8), steps a run
MAMBA_TRAIN_LAYERS, MOE_TRAIN_LAYERS = 32, 6
MAMBA_GRAD_LAYERS, MAMBA_GRAD_BATCH = 4, 2
# qwen2-moe's depth in f32, for its routing flips without bf16, and what
# is held there as f32 rounding: a flip that no earlier layer carries with
# both paths' margins within MOE_F32_TIE, losses within MOE_F32_LOSS_REL.
# Measured on an H100 80GB HBM3 at 700 W (PERF.md): no flip, the losses
# equal in the six decimals printed, the router probabilities 1e-7 to 2e-7
# apart (median a layer)
MOE_F32_LAYERS, MOE_F32_TIE, MOE_F32_LOSS_REL = 4, 1e-5, 1e-5
FAMILY_STEPS = 4
# each family's step-0 gradients are held to phase 22's GRAD_REL_L2_BOUND
# and LOSS_REL_BOUND.  Measured on an H100 80GB HBM3 at 700 W (PERF.md):
# falcon-mamba 0.0182 (the scan with a chunk's carry dropped: 0.2236),
# qwen2-moe routed alike 0.0258 (by its own top-k: 0.4223, tokens
# flipped), seamless-m4t 0.0502


def _scan_fault_step(l):
    """The step whose g is not carried into the chunk before it by the
    planted fault: the start of the middle chunk of the kernel's, None
    where L is one chunk."""
    chunks = -(-l // mamba_scan.BWD_CHUNK)
    return mamba_scan.BWD_CHUNK * (chunks // 2) if chunks > 1 else None


def _scan_bwd_fault(u, dt, a, b, c, d_skip, dy, drop_at=None, no_ah=False):
    """``selective_scan_bwd_ref``'s recurrence with a planted fault: g not
    carried from step ``drop_at`` into the step before it, or ddt without
    its ``A a_t h_{t-1}`` term.  Returns (du, ddt, dA, dB, dC, dD) in f32."""
    f = torch.float32
    a = a.to(f)
    u, dt, b, c, dy = (t.to(f) for t in (u, dt, b, c, dy))
    h = torch.zeros((u.shape[0], u.shape[2], a.shape[1]), dtype=f,
                    device=u.device)
    hs = [h]
    for t in range(u.shape[1]):
        h = torch.exp(dt[:, t, :, None] * a) * h \
            + (dt[:, t] * u[:, t])[:, :, None] * b[:, t, None, :]
        hs.append(h)
    du, ddt = torch.empty_like(u), torch.empty_like(u)
    db, dc = torch.empty_like(b), torch.empty_like(c)
    da, g, a_next = torch.zeros_like(a), torch.zeros_like(h), None
    for t in reversed(range(u.shape[1])):
        at = torch.exp(dt[:, t, :, None] * a)
        if t + 1 == drop_at:
            g = torch.zeros_like(g)
        g = dy[:, t, :, None] * c[:, t, None, :] + (
            0 if a_next is None else a_next * g)
        ah = at * hs[t]
        du[:, t] = dt[:, t] * (g * b[:, t, None, :]).sum(2) \
            + d_skip[None] * dy[:, t]
        ub = u[:, t, :, None] * b[:, t, None, :]
        ddt[:, t] = (g * (ub if no_ah else ub + a * ah)).sum(2)
        da += (g * dt[:, t, :, None] * ah).sum(0)
        db[:, t] = (g * (dt[:, t] * u[:, t])[:, :, None]).sum(1)
        dc[:, t] = (dy[:, t, :, None] * hs[t + 1]).sum(1)
        a_next = at
    return du, ddt, da, db, dc, (dy * u).sum((0, 1))


def _scan_bwd_inputs(shape, gen, dev):
    """u, dt, a, B, C, d_skip of ``scan_inputs`` and dy (f32); u and dt as
    slices of (B, L, Din + 1) rows where the shape asks for rows off
    16-byte alignment."""
    b, l, d, n, dt, strided, misaligned = shape
    args = list(scan_inputs(gen, b, l, d, n, dev, dt, strided))
    if misaligned:
        for i in (0, 1):
            wide = torch.zeros((b, l, d + 1), dtype=dt, device=dev)
            wide[..., 1:] = args[i]
            args[i] = wide[..., 1:]
    dy = torch.randn((b, l, d), generator=gen, device=dev)
    return args, dy


def _scan_bwd_limit(want, dt):
    """2e-3 x max|g| in f32, 2^-6 x max|g| in bf16 (two bf16 steps at the
    largest value: the kernels and the plain version both sum in f32 and
    round once), scaled by max|g| itself: scan gradients can be far below
    1."""
    m = want.float().abs().max().item()
    return (2e-3 if dt == torch.float32 else 2.0 ** -6) * m


def phase_scan_bwd(dev):
    """Phase 23, the kernels: at every shape of ``SCAN_BWD_SHAPES`` the
    backward's six gradients against ``selective_scan_bwd_ref`` within
    ``_scan_bwd_limit``, in the input's dtype and shape, and two calls
    bit-equal; each limit shown to see a fault: the plain version with g's
    carry dropped at ``_scan_fault_step`` and with ddt's ``A a h`` term left
    out must miss it on every gradient the fault reaches
    (``SCAN_FAULT_REACH``).  Prints max|g|, the limits and errors.  Then the
    times at falcon-mamba's training shape."""
    gen = torch.Generator(device=dev).manual_seed(23)
    before = _all_counts()
    err = {"f32": 0.0, "bf16": 0.0}
    readings = []
    for shape in SCAN_BWD_SHAPES:
        b, l, d, n, dt, _, _ = shape
        args, dy = _scan_bwd_inputs(shape, gen, dev)
        got = mamba_scan.selective_scan_bwd(*args, dy)
        again = mamba_scan.selective_scan_bwd(*args, dy)
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            raise AssertionError(f"[23] scan backward {shape[:5]}: two calls "
                                 f"differ")
        want = selective_scan_bwd_ref(*args, dy)
        t0 = _scan_fault_step(l)
        faults = {}                  # at L = 1 h_{-1} = 0: no A a h term
        if l > 1:
            faults["A a h"] = _scan_bwd_fault(*args, dy, no_ah=True)
        if t0 is not None:
            faults["carry"] = _scan_bwd_fault(*args, dy, drop_at=t0)
        key = "f32" if dt == torch.float32 else "bf16"
        row = {"shape": [b, l, d, n, key], "fault_step": t0}
        for i, (name, g, w) in enumerate(zip(SCAN_GRADS, got, want)):
            limit = _scan_bwd_limit(w, dt)
            e = (g.float() - w.float()).abs().max().item()
            if g.dtype != w.dtype or g.shape != w.shape or \
                    not torch.isfinite(g).all() or not e <= limit:
                raise AssertionError(f"[23] scan backward {shape[:5]} {name}: "
                                     f"{g.dtype} {tuple(g.shape)}, max err "
                                     f"{e} over the limit {limit}")
            miss = {f: (fw[i] - w.float()).abs().max().item()
                    for f, fw in faults.items()}
            for f, m in miss.items():
                if name in SCAN_FAULT_REACH[f] and not m > limit:
                    raise AssertionError(f"[23] scan backward {shape[:5]} "
                                         f"{name}: the limit {limit} would "
                                         f"pass the planted fault {f} ({m})")
            err[key] = max(err[key], e)
            row[name] = {"max_g": w.float().abs().max().item(),
                         "limit": limit, "err": e, "fault_err": miss}
        readings.append(row)
        print(f"[23] scan backward {row['shape']}: " + "; ".join(
            f"{k} max|g| {row[k]['max_g']:.4g}, limit {row[k]['limit']:.4g}, "
            f"err {row[k]['err']:.4g}" + "".join(
                f", {f} {m:.4g}" for f, m in row[k]["fault_err"].items()
                if k in SCAN_FAULT_REACH[f]) for k in SCAN_GRADS))
        del got, again, want, faults, args, dy
    torch.cuda.synchronize()
    print(f"[23] {len(SCAN_BWD_SHAPES)} scan backward shapes agree with "
          f"selective_scan_bwd_ref: max abs err {err['f32']:.3g} (f32), "
          f"{err['bf16']:.3g} (bf16); two calls bit-equal at every shape; "
          f"every limit missed by each planted fault it reaches")
    times = _scan_bwd_times(gen, dev)
    _set_counts(before)                # checking launches do not count
    return {"err": err, "readings": readings, "times": times}


def _scan_bwd_bound(b, l, d, n, elem):
    """The backward's least time: u, dt, B, C, A, D and dy read once, du,
    ddt, dA, dB, dC, dD written once; 14 f32 operations a (b, t, d, n) (the
    state's recompute 3, g 2, du's and ddt's terms 5, dA's 2, dB's and dC's
    2); the exponentials' time on the special-function units, once each, as
    an estimate beside it."""
    nbytes = (4 * b * l * d * elem + 4 * b * l * n * elem + 2 * d * n * 4
              + 2 * d * 4 + b * l * d * 4)
    ops = 14 * b * l * d * n
    t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS["f32"] * 1e3
    exp_ms = b * l * d * n / EXP_PER_S * 1e3
    return ((t_b, "bytes") if t_b >= t_o else (t_o, "operations")), exp_ms


def _scan_bwd_times(gen, dev):
    """At falcon-mamba's training shape in bf16 (B and C strided): the
    backward call's µs (events), each kernel's device µs and the call's
    (``_device_total_us``), the forward kernel's µs, the plain version's
    ms, the bound and the exponentials' estimate."""
    shape = SCAN_BWD_SHAPES[0]
    b, l, d, n, dt = shape[:5]
    args, dy = _scan_bwd_inputs(shape, gen, dev)
    call = lambda: mamba_scan.selective_scan_bwd(*args, dy)
    fwd = lambda: mamba_scan.selective_scan(*args)
    out = {"shape": [b, l, d, n, "bfloat16"],
           "ms": _events_ms(call, reps=10, trials=5, warmup=2),
           "dev_us": {k: _device_us(call, k, reps=10, tries=3)
                      for k in mamba_scan.BWD_KERNELS},
           "call_dev_us": _device_total_us(
               call, f"[23] scan backward call at {shape[:4]}", reps=10,
               whole=True),
           "fwd_ms": _events_ms(fwd, reps=10, trials=5, warmup=2),
           "plain_ms": _events_ms(lambda: selective_scan_bwd_ref(*args, dy),
                                  reps=1, trials=3, warmup=1)}
    (bound, by), exp_ms = _scan_bwd_bound(b, l, d, n, 2)
    out.update(bound_ms=bound, bound_by=by, exp_ms=exp_ms)
    print(f"[23] scan backward at {out['shape']}: {out['ms'] * 1e3:.2f} us "
          f"per call (events), device {_us(out['call_dev_us'])} (" + ", ".join(
              f"{k} {_us(v)}" for k, v in out["dev_us"].items())
          + f"); bound {bound * 1e3:.2f} us ({by}); exponentials once each "
          f"at 16 per clock per SM: {exp_ms * 1e3:.1f} us (the bounds walk "
          f"takes them once, the reverse walk's recompute 1.75 times); plain "
          f"{out['plain_ms']:.1f} ms; the forward kernel "
          f"{out['fwd_ms'] * 1e3:.2f} us per call")
    return out


@contextlib.contextmanager
def _scan_carry_dropped():
    """While entered, the scan's backward drops g's carry at
    ``_scan_fault_step``: du, ddt and dB of the steps before it come from a
    second launch on dy zeroed from that step on (dA keeps the full
    launch's sum; dC and dD take no g).  A fault the full-width gradient
    check must see."""
    bwd = mamba_scan.selective_scan_bwd

    def faulted(u, dt, a, b, c, d_skip, dy):
        du, ddt, da, db, dc, dd = bwd(u, dt, a, b, c, d_skip, dy)
        t0 = _scan_fault_step(u.shape[1])
        if t0 is not None:
            lo = dy.clone()
            lo[:, t0:] = 0
            du2, ddt2, _, db2, _, _ = bwd(u, dt, a, b, c, d_skip, lo)
            du[:, :t0], ddt[:, :t0], db[:, :t0] = (
                du2[:, :t0], ddt2[:, :t0], db2[:, :t0])
        return du, ddt, da, db, dc, dd
    mamba_scan.selective_scan_bwd = faulted
    try:
        yield
    finally:
        mamba_scan.selective_scan_bwd = bwd


def _family_batch(cfg, b, s, seed=0):
    return SyntheticLMData(cfg.vocab_size, b, s, seed,
                           embed_dim=cfg.d_model if cfg.embed_inputs else 0,
                           encdec=cfg.is_encdec).next()


@contextlib.contextmanager
def _routes_spied(record=None, replay=None, margins=None):
    """While entered, every router top-k call (``torch.topk``): with
    ``record`` (a list) its indices are appended to it on the host, in
    call order; with ``margins`` (a list) its router probabilities and its
    k-th minus (k+1)-th probability; with ``replay`` (such a list from
    another pass) call i routes by ``replay[i]`` instead of its own top-k,
    its weights gathered from its own probabilities, so that both passes
    route every token alike."""
    calls = []
    real = torch.topk

    def spy(x, k, *a, **kw):
        out = real(x, k, *a, **kw)
        if replay is not None:
            idx = replay[len(calls)].to(x.device)
            out = torch.return_types.topk((torch.gather(x, -1, idx), idx))
        calls.append(out.indices)
        if margins is not None:
            top = real(x.detach(), k + 1, dim=-1).values
            margins.append((x.detach().cpu(),
                            (top[..., k - 1] - top[..., k]).cpu()))
        return out
    if record is not None or replay is not None or margins is not None:
        torch.topk = spy
    try:
        yield
    finally:
        torch.topk = real
    if record is not None:
        record += [i.cpu() for i in calls]


def _host_grads(cfg, model, batch, use_kernel, record=None, replay=None,
                margins=None):
    """(loss, {name: gradient on the host}) of one loss and backward, its
    router calls, the loss's forward and the backward's recompute, spied
    on as ``_routes_spied`` says."""
    with _routes_spied(record, replay, margins):
        for p in model.parameters():
            p.grad = None
        loss, _ = port_models.loss(cfg, model, batch, use_kernel)
        loss.backward()
    grads = {n: p.grad.cpu() for n, p in model.named_parameters()
             if p.grad is not None}
    for p in model.parameters():
        p.grad = None
    return loss.item(), grads


def _host_rel_l2(got, want, dev):
    """``_rel_l2`` of host gradients, each pair moved to ``dev`` in turn."""
    return {k: _rel_l2({k: got[k].to(dev)}, {k: want[k].to(dev)})[k]
            for k in want}


def _recompute_order_undone(cfg, calls):
    """A forward's and its remat's router calls (``calls``: the forward's
    MoE layers in order, then the backward's recompute, which takes the
    periods last first and each period's layers in order) as (the
    forward's, the recompute's put back in forward order)."""
    layers = len(calls) // 2
    if len(calls) != 2 * layers or layers % lm.n_periods(cfg):
        raise AssertionError(f"{len(calls)} router calls for "
                             f"{lm.n_periods(cfg)} remat periods")
    per = layers // lm.n_periods(cfg)
    rec = calls[layers:]
    chunks = [rec[i:i + per] for i in range(0, layers, per)]
    return calls[:layers], [c for chunk in chunks[::-1] for c in chunk]


def _flip_readings(k_routes, p_routes, k_marg, p_marg):
    """The kernel path's routing (``k_routes``; ``k_marg``: its router
    probabilities and k-th minus (k+1)-th margins, (G, T) a layer) against
    the plain path's by its own top-k, for each MoE layer of one forward:
    the tokens whose top-k sets differ (``flips``, and the larger of the
    two paths' margins there, median); those of them with no
    flip at an earlier layer at this or an earlier position of their row
    (``fresh``: causal attention carries a flipped token's change to the
    later tokens of its row, so only at a fresh flip do the router's inputs
    differ by the paths' rounding alone); both paths' margins at the fresh
    flips (median, max) against the kernel path's margins over every token
    (median, 1st percentile); and the fresh flips at which both paths'
    margins are below the median largest |router probability difference|
    over the tokens that neither flip nor are carried (``near_tie``,
    phase 11's rule)."""
    out = []
    carried = None
    for a, b, (kp, km), (pp, pm) in zip(k_routes, p_routes, k_marg, p_marg):
        flip = (a.sort(-1).values != b.sort(-1).values).any(-1)   # (G, T)
        clean = ~flip if carried is None else ~(flip | carried)
        fresh = flip if carried is None else flip & ~carried
        gap = (kp - pp).abs().amax(-1)
        noise = gap[clean].median().item() if clean.any() else None
        both = torch.maximum(km[fresh], pm[fresh])
        every = torch.maximum(km[flip], pm[flip])
        out.append({
            "flips": int(flip.sum()), "fresh": int(fresh.sum()),
            "flip_margin_median": (every.median().item() if every.numel()
                                   else None),
            "fresh_margin_median": (both.median().item() if both.numel()
                                    else None),
            "fresh_margin_max": both.max().item() if both.numel() else None,
            "margin_median": km.median().item(),
            "margin_p01": km.flatten().quantile(0.01).item(),
            "clean_diff_median": noise,
            "near_tie": (int((both < noise).sum()) if noise is not None
                         else None)})
        seen = flip if carried is None else flip | carried
        carried = torch.cummax(seen.to(torch.int8), dim=1).values.bool()
    return out


def _print_flips(tag, by_layer):
    """``_flip_readings``' readings, a line a MoE layer."""
    for i, r in enumerate(by_layer):
        print(f"[23] {tag} MoE layer {i}: {r['flips']} flips (the "
              f"larger margin there: median {r['flip_margin_median']}), "
              f"{r['fresh']} fresh (no flip at an earlier layer at or "
              f"before the token in its row); the larger of the two "
              f"paths' k-th minus (k+1)-th probability at the fresh "
              f"flips: median {r['fresh_margin_median']}, max "
              f"{r['fresh_margin_max']}; the kernel path's over every "
              f"token: median {r['margin_median']}, 1st percentile "
              f"{r['margin_p01']}; median probability difference over "
              f"the tokens neither flipped nor carried "
              f"{r['clean_diff_median']}; fresh flips with both margins "
              f"below it (near ties): {r['near_tie']} of {r['fresh']}")


def _grad_check(tag, cfg, model, batch, want_counts, fault=None,
                twice=False):
    """Step 0's loss and every parameter's gradient, kernel path against
    ``use_kernel=False`` on the same batch: the loss within
    ``LOSS_REL_BOUND``, each gradient's relative L2 within
    ``GRAD_REL_L2_BOUND``, the kernel path's launches ``want_counts``
    exactly, and, with
    ``fault`` (a context), the largest relative L2 with the fault planted
    over the bound; with ``twice``, a second kernel-path backward bit-equal
    to the first.  A MoE model is held with the plain path routed as the
    kernel path routed (``_host_grads``' replay): the attention's rounding
    flips the router's top-k of some tokens, and a flipped token's
    gradients go to other experts.  The free-routing comparison and the
    flips by layer are printed, not held, as phase 11 prints them, with
    ``_flip_readings``' margins; held are the recomputed forward's routes,
    equal to the first forward's on both paths."""
    bound = GRAD_REL_L2_BOUND
    dev = batch["labels"].device
    moe = cfg.moe is not None
    routes = [] if moe else None
    k_marg = [] if moe else None
    before = _all_counts()
    _zero_counts()
    loss_k, kern = _host_grads(cfg, model, batch, True, record=routes,
                               margins=k_marg)
    counts = _nonzero(_all_counts())
    _expect(_all_counts(), want_counts, f"[23] {tag} one kernel-path step")
    loss_p, plain = _host_grads(cfg, model, batch, False, replay=routes)
    out = {"loss_kernel": loss_k, "loss_plain": loss_p,
           "loss_rel": abs(loss_k - loss_p) / abs(loss_p),
           "launches": counts}
    rel = _host_rel_l2(kern, plain, dev)
    finite = all(torch.isfinite(g).all() for g in kern.values())
    if set(kern) != set(plain) or len(kern) != len(list(
            model.parameters())):
        raise AssertionError(f"[23] {tag}: a parameter has no gradient")
    worst = sorted(rel.items(), key=lambda kv: -kv[1])[:5]
    out.update(grad_rel_l2_max=worst[0][1],
               grad_rel_l2_median=statistics.median(rel.values()),
               worst=worst, bound=bound, routing_matched=moe)
    if moe:
        free, p_marg = [], []
        loss_f, plain_f = _host_grads(cfg, model, batch, False, record=free,
                                      margins=p_marg)
        k_fwd, k_rec = _recompute_order_undone(cfg, routes)
        p_fwd, p_rec = _recompute_order_undone(cfg, free)
        out["recompute_routes_equal"] = {
            "kernel": all(map(torch.equal, k_fwd, k_rec)),
            "plain": all(map(torch.equal, p_fwd, p_rec))}
        layers = len(k_fwd)
        rel_f = _host_rel_l2(kern, plain_f, dev)
        flips = _flip_readings(k_fwd, p_fwd, k_marg[:layers],
                               p_marg[:layers])
        out["free_routing"] = {
            "loss_rel": abs(loss_k - loss_f) / abs(loss_f),
            "grad_rel_l2_max": max(rel_f.values()),
            "grad_rel_l2_median": statistics.median(rel_f.values()),
            "flips_by_layer": [f["flips"] for f in flips],
            "by_layer": flips}
        del plain_f, k_marg, p_marg
    if twice:
        _, again = _host_grads(cfg, model, batch, True)
        out["bit_equal"] = all(torch.equal(again[k], kern[k]) for k in kern)
        del again
    del kern
    if fault is not None:
        with fault():
            _, bad = _host_grads(cfg, model, batch, True)
        fault_rel = _host_rel_l2(bad, plain, dev)
        fw = sorted(fault_rel.items(), key=lambda kv: -kv[1])[:5]
        out.update(fault_grad_rel_l2_max=fw[0][1], fault_worst=fw)
        del bad
    _set_counts(before)
    print(f"[23] {tag} step 0, kernel path against plain path"
          + (" (routed as the kernel path)" if moe else "") + f": loss "
          f"{loss_k:.6f} against {loss_p:.6f} (relative "
          f"{out['loss_rel']:.3g}, bound {LOSS_REL_BOUND}); gradients' "
          f"relative L2 over {len(rel)} parameters: max {worst[0][1]:.4g}, "
          f"median {out['grad_rel_l2_median']:.4g}, bound {bound}; worst "
          + ", ".join(f"{k} {v:.4g}" for k, v in worst)
          + f"; launches {counts}"
          + (f"; a second backward bit-equal: {out['bit_equal']}"
             if twice else ""))
    if moe:
        f = out["free_routing"]
        print(f"[23] {tag} step 0 against the plain path routing by its own "
              f"top-k (printed, not held): loss relative {f['loss_rel']:.3g}"
              f"; gradients' relative L2 max {f['grad_rel_l2_max']:.4g}, "
              f"median {f['grad_rel_l2_median']:.4g}; routing flips by layer "
              f"(tokens whose top-k set differs, of "
              f"{batch['labels'].numel()}) {f['flips_by_layer']}")
        _print_flips(tag, f["by_layer"])
        print(f"[23] {tag} the backward's recomputed forward routes every "
              f"token as the first forward did: "
              f"{out['recompute_routes_equal']}")
    if fault is not None:
        print(f"[23] {tag} step 0 with the planted fault: gradients' "
              f"relative L2 max {out['fault_grad_rel_l2_max']:.4g}; worst "
              + ", ".join(f"{k} {v:.4g}" for k, v in out["fault_worst"]))
    if not (out["loss_rel"] <= LOSS_REL_BOUND and worst[0][1] <= bound
            and finite):
        raise AssertionError(f"[23] {tag}: the kernel path's step-0 loss or "
                             f"gradients are off the plain path's")
    if moe and not all(out["recompute_routes_equal"].values()):
        raise AssertionError(f"[23] {tag}: the recomputed forward routed "
                             f"otherwise than the first "
                             f"{out['recompute_routes_equal']}")
    if twice and not out["bit_equal"]:
        raise AssertionError(f"[23] {tag}: two backward passes on the same "
                             f"inputs differ")
    if fault is not None and not out["fault_grad_rel_l2_max"] > bound:
        raise AssertionError(f"[23] {tag}: the bound {bound} would pass the "
                             f"planted fault "
                             f"({out['fault_grad_rel_l2_max']})")
    return out


def _train_steps(tag, tr, state, per_step):
    """``FAMILY_STEPS`` steps of ``tr.run`` (the captured step, the
    default: ``WARMUP_STEPS`` eager steps, a capture, replays), the counts
    zeroed just before and exactly ``FAMILY_STEPS`` x ``per_step`` and one
    AdamW call a step after: each step's loss (finite), ms (CUDA events),
    tokens/s and peak allocated memory (a replay's: its capture's peak),
    the eager steps' peak against the capture's, and the capture's ms."""
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    tr.run(FAMILY_STEPS, state=state)
    counts = _nonzero(_all_counts())
    per_step = {**per_step, "adamw": 1}
    _expect(_all_counts(), {k: v * FAMILY_STEPS for k, v in per_step.items()},
            f"[23] {tag} {FAMILY_STEPS} steps of Trainer.run")
    want = [False] * 2 + [True] * (FAMILY_STEPS - 2)
    if tr.replayed != want:
        raise AssertionError(f"[23] {tag}: replayed {tr.replayed}")
    if not all(math.isfinite(x) for x in tr.history):
        raise AssertionError(f"[23] {tag}: non-finite losses {tr.history}")
    tokens = tr.batch * tr.seq_len
    for i, (loss, ms, peak, rep) in enumerate(zip(
            tr.history, tr.step_ms, tr.peak_bytes, tr.replayed)):
        print(f"[23] {tag} step {i}{' (replay)' if rep else ''}: loss "
              f"{loss:.4f}, {ms:.1f} ms (CUDA "
              f"events), {tokens / ms * 1e3:.0f} tokens/s, peak allocated "
              f"{peak / 2**30:.2f} GiB")
    eager_peak = max(p for p, r in zip(tr.peak_bytes, tr.replayed) if not r)
    print(f"[23] {tag} {FAMILY_STEPS} steps: launches {counts} (exact); "
          f"peak allocated eager {eager_peak / 2**30:.2f} GiB, captured "
          f"{tr.graph.peak_bytes / 2**30:.2f} GiB (the capture's); capture "
          f"{tr.graph.capture_ms:.0f} ms; reserved "
          f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB")
    return {"batch": tr.batch, "seq_len": tr.seq_len, "losses": tr.history,
            "step_ms": tr.step_ms, "replayed": tr.replayed,
            "peak_gib": [p / 2**30 for p in tr.peak_bytes],
            "eager_peak_gib": eager_peak / 2**30,
            "captured_peak_gib": tr.graph.peak_bytes / 2**30,
            "capture_ms": tr.graph.capture_ms, "launches": counts}


def _trainer_state(tag, cfg, dev):
    tr = Trainer(cfg=cfg, batch=BATCH, seq_len=PROMPT, peak_lr=TRAIN_LR,
                 device=dev)
    t0 = time.perf_counter()
    state = tr.init_state()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in state.model.parameters())
    print(f"[23] {tag}: {n_params} trainable parameters and their "
          f"{cfg.adam_dtype} moments on the card in "
          f"{time.perf_counter() - t0:.1f} s; "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    return tr, state, n_params


def phase_train_mamba(dev):
    """Phase 23, falcon-mamba-7b at full width: first step 0's gradients
    against the plain chunked scan (depth ``MAMBA_GRAD_LAYERS``, batch
    ``MAMBA_GRAD_BATCH`` x 512), the bound shown to see the kernel with g's
    carry dropped (``_scan_carry_dropped``); then ``Trainer`` at depth
    ``MAMBA_TRAIN_LAYERS`` on B = 8 x 512 with f32 moments and remat: the
    scan's forward launches twice a layer a step, its backward once, flash
    attention never."""
    full = get_arch(MAMBA_ARCH)
    cfg = dataclasses.replace(full, n_layers=MAMBA_GRAD_LAYERS)
    model = build_model(cfg, dev, seed=0).requires_grad_(True)
    batch = to_device(_family_batch(cfg, MAMBA_GRAD_BATCH, PROMPT), dev)
    print(f"[23] {MAMBA_ARCH} step-0 check at depth {MAMBA_GRAD_LAYERS} of "
          f"{full.n_layers}, batch cut to {MAMBA_GRAD_BATCH} of {BATCH} x "
          f"{PROMPT}: the plain chunked scan's autograd holds ~64 GB a layer "
          f"at B = {BATCH}")
    n = cfg.n_layers
    check = _grad_check(MAMBA_ARCH, cfg, model, batch,
                        {"selective_scan": 2 * n, "selective_scan_bwd": n,
                         "flash_attention": 0, "flash_attention_bwd": 0},
                        fault=_scan_carry_dropped)
    del model, batch
    _free()
    cfg = dataclasses.replace(full, n_layers=MAMBA_TRAIN_LAYERS)
    tag = f"{MAMBA_ARCH} ({MAMBA_TRAIN_LAYERS} of {full.n_layers} layers)"
    tr, state, n_params = _trainer_state(tag, cfg, dev)
    n = cfg.n_layers
    out = _train_steps(tag, tr, state, {"selective_scan": 2 * n,
                                        "selective_scan_bwd": n,
                                        "flash_attention": 0,
                                        "flash_attention_bwd": 0})
    out.update(arch=MAMBA_ARCH, layers=n, params=n_params, step0=check)
    del state, tr
    _free()
    return out


def phase_train_moe(dev):
    """Phase 23, qwen2-moe-a2.7b at full width, depth ``MOE_TRAIN_LAYERS``
    (60 experts top-4, 4 shared, bf16), ``Trainer`` on B = 8 x 512: step 0's
    gradients against the plain attention (routed as the kernel path;
    routing flips printed), two kernel-path backward passes bit-equal (the
    dispatch's determinism on the card); flash attention 2 forward
    launches a layer a step and 1 backward."""
    full = get_arch(MOE_ARCH)
    cfg = dataclasses.replace(full, n_layers=MOE_TRAIN_LAYERS)
    tag = f"{MOE_ARCH} ({MOE_TRAIN_LAYERS} of {full.n_layers} layers)"
    tr, state, n_params = _trainer_state(tag, cfg, dev)
    n = cfg.n_layers
    per_step = {"flash_attention": 2 * n, "flash_attention_bwd": n,
                "selective_scan": 0, "selective_scan_bwd": 0}
    batch = to_device(_family_batch(cfg, BATCH, PROMPT, tr.seed), dev)
    check = _grad_check(tag, cfg, state.model, batch, per_step, twice=True)
    del batch
    _free()
    out = _train_steps(tag, tr, state, per_step)
    out.update(arch=MOE_ARCH, layers=n, params=n_params, step0=check)
    del state, tr
    _free()
    return out


def _forward_routes(cfg, model, batch, use_kernel):
    """One forward of the loss, without autograd: (loss, each router top-k
    call's indices, each call's (router probabilities, k-th minus (k+1)-th
    probability)), in call order, on the host."""
    routes, margins = [], []
    with _routes_spied(routes, margins=margins), torch.no_grad():
        loss, _ = port_models.loss(cfg, model, batch, use_kernel)
    return loss.item(), routes, margins


def _f32_routing_faults(loss_k, loss_p, by_layer):
    """What of an f32 forward's routing readings (``_flip_readings``) is not
    f32 rounding: each MoE layer with a fresh flip at which either path's
    margin passes ``MOE_F32_TIE`` (the other path then chose apart from a
    tie), and losses apart by more than ``MOE_F32_LOSS_REL``."""
    out = [f"MoE layer {i}: {f['fresh']} fresh flips, margins up to "
           f"{f['fresh_margin_max']}" for i, f in enumerate(by_layer)
           if f["fresh"] and f["fresh_margin_max"] > MOE_F32_TIE]
    if abs(loss_k - loss_p) > MOE_F32_LOSS_REL * abs(loss_p):
        out.append(f"loss {loss_k} against {loss_p}")
    return out


def phase_moe_f32_routing(dev):
    """Phase 23, qwen2-moe-a2.7b at full width and ``MOE_F32_LAYERS``
    layers in f32 (weights from seed 0): one forward of the loss on B = 8 x
    512 tokens from seed 0 on each path, each routing by its own top-k; the
    flips by layer and their margins (``_flip_readings``), printed and held
    by ``_f32_routing_faults``.  In f32 the two paths' attention differs by
    f32 rounding alone: a flip far from a tie is a fault of a path."""
    full = get_arch(MOE_ARCH)
    cfg = dataclasses.replace(full, n_layers=MOE_F32_LAYERS,
                              param_dtype="float32",
                              compute_dtype="float32")
    model = build_model(cfg, dev, seed=0)
    batch = to_device(_family_batch(cfg, BATCH, PROMPT), dev)
    before = _all_counts()
    loss_k, k_routes, k_marg = _forward_routes(cfg, model, batch, True)
    loss_p, p_routes, p_marg = _forward_routes(cfg, model, batch, False)
    _set_counts(before)
    flips = _flip_readings(k_routes, p_routes, k_marg, p_marg)
    tag = f"{MOE_ARCH} f32 ({MOE_F32_LAYERS} of {full.n_layers} layers)"
    print(f"[23] {tag}, one forward a path, each routing by its own top-k "
          f"(held to f32 rounding): loss {loss_k:.6f} against {loss_p:.6f}; "
          f"routing flips by layer (tokens whose top-k set differs, of "
          f"{batch['labels'].numel()}) {[f['flips'] for f in flips]}")
    _print_flips(tag, flips)
    del model, batch, k_marg, p_marg
    _free()
    bad = _f32_routing_faults(loss_k, loss_p, flips)
    if bad:
        raise AssertionError(f"[23] {tag}: the paths part by more than f32 "
                             f"rounding: {bad}")
    return {"layers": MOE_F32_LAYERS, "loss_kernel": loss_k,
            "loss_plain": loss_p, "by_layer": flips}


def phase_train_encdec(dev):
    """Phase 23, seamless-m4t-large-v2 at full width and depth (24 + 24
    layers), ``Trainer`` on ``SyntheticLMData(encdec=True)`` batches of
    B = 8 x 512: step 0's gradients against the plain attention; flash
    attention forward twice and backward once for each of its 72 calls a
    step (encoder self, decoder self and cross) under remat."""
    cfg = get_arch(ENCDEC_ARCH)
    tr, state, n_params = _trainer_state(ENCDEC_ARCH, cfg, dev)
    calls = cfg.encoder_layers + 2 * cfg.n_layers
    per_step = {"flash_attention": 2 * calls, "flash_attention_bwd": calls}
    batch = to_device(_family_batch(cfg, BATCH, PROMPT, tr.seed), dev)
    check = _grad_check(ENCDEC_ARCH, cfg, state.model, batch, per_step)
    del batch
    _free()
    out = _train_steps(ENCDEC_ARCH, tr, state, per_step)
    out.update(arch=ENCDEC_ARCH, params=n_params, step0=check)
    del state, tr
    _free()
    return out


def phase_train_hybrid(dev):
    """Phase 23, jamba-1.5-large-398b at its smoke width in f32 with
    head_dim 32 (Mamba, attention and MoE layers; the f32 scan backward and
    the CUDA-core attention backward): 40 steps at ``peak_lr=1e-2`` whose
    loss falls as ``tests/test_train.py`` requires, launches exact, and a
    run killed at step 12 and resumed from its step-10 checkpoint bit-equal
    to the uninterrupted run."""
    cfg = dataclasses.replace(smoke_config(HYBRID_ARCH), head_dim=32)
    kinds = lm.period_structure(cfg)
    n_m = sum(k["mixer"] == "mamba" for k in kinds) * lm.n_periods(cfg)
    n_a = cfg.n_layers - n_m
    kw = dict(cfg=cfg, batch=8, seq_len=32, peak_lr=1e-2, device=dev,
              ckpt_every=5)
    steps = 40
    _zero_counts()
    tr = Trainer(**kw)
    tr.run(steps)
    counts = _nonzero(_all_counts())
    _expect(_all_counts(), {"selective_scan": 2 * n_m * steps,
                            "selective_scan_bwd": n_m * steps,
                            "flash_attention": 2 * n_a * steps,
                            "flash_attention_bwd": n_a * steps,
                            "adamw": steps},
            "[23] jamba smoke-width training")
    first, last = np.mean(tr.history[:5]), np.mean(tr.history[-5:])
    if not last < first - 0.2:
        raise AssertionError(f"[23] jamba smoke-width loss {first} -> {last}")
    _kill_and_resume("[23] jamba smoke width", kw)
    print(f"[23] jamba smoke width (d {cfg.d_model}, head_dim 32, f32, "
          f"{cfg.adam_dtype} moments) on the card: {steps} steps, loss "
          f"{first:.4f} -> {last:.4f} (mean of the first and last five); "
          f"launches {counts}; killed at 12, resumed from step 10: the 10 "
          f"losses equal the uninterrupted run's bit for bit")
    return {"losses": tr.history, "launches": counts, "resumed_equal": True}


def scan_bwd_kernel_row(kern, mamba, hybrid):
    """Phase 23 in the ``kernels`` line: the scan backward (three kernels a
    call), timed at falcon-mamba's training shape, its launches on the
    full-width falcon-mamba run and on jamba's smoke-width run."""
    t = kern["times"]
    by_path = {"falcon_mamba_full_width":
               mamba["launches"].get("selective_scan_bwd", 0),
               "jamba_smoke_width":
               hybrid["launches"].get("selective_scan_bwd", 0)}
    if not all(by_path.values()):
        raise AssertionError(f"[23] selective_scan_bwd launches {by_path}")
    dev_ms = _ms(t["call_dev_us"])
    return {"name": "selective_scan_bwd", "route": "cuda",
            "source": SCAN_BWD_SOURCE, "replaces": SCAN_BWD_REPLACES,
            "launches": by_path["falcon_mamba_full_width"],
            "launches_by_path": by_path,
            "max_abs_err": kern["err"]["f32"],
            "max_abs_err_bf16": kern["err"]["bf16"],
            "ms": t["ms"] if dev_ms is None else dev_ms,
            "ms_is": "events" if dev_ms is None else "device",
            "events_ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None,
            "kernels_device_ms": {k: _ms(v) for k, v in t["dev_us"].items()},
            "forward_ms": t["fwd_ms"], "shape": t["shape"],
            "checks": kern["readings"]}


# (C, H, W, FL, FH, FW, stride, pad)
CM_CONV = (28, 16, 16, 28, 3, 3, 1, 1)              # the CM main path's
CONV_SHAPES = [CM_CONV,
               (1, 28, 28, 4, 3, 3, 1, 0), (4, 13, 13, 8, 3, 3, 1, 0),  # lenet
               (4, 8, 8, 4, 3, 3, 1, 1),                                # fig2
               (8, 4, 1, 16, 1, 1, 1, 0),                # tiny transformer
               (3, 8, 8, 8, 3, 3, 1, 1), (4, 12, 12, 16, 3, 3, 2, 0),
               (1, 6, 6, 4, 1, 1, 1, 0), (2, 9, 7, 8, 3, 3, 1, 2),
               (256, 32, 32, 256, 1, 1, 1, 0),          # a full crossbar
               (256, 8, 8, 256, 3, 3, 1, 1),     # K = 2304: weights in chunks
               (6, 11, 17, 10, 3, 3, 2, 1)]              # stride 2, 11 x 17
FAULT_RATE, FAULT_HORIZON, FAULT_DEADLINE = 0.5, 400, 400
FAULT_RETRY = RetryPolicy(max_retries=3, backoff_cycles=32)


def _conv_inputs(shape, wdtype, gen, dev):
    c, h, w, fl, fh, fw, _, _ = shape
    wf = torch.randn(fl, c * fh * fw, generator=gen)
    if wdtype == "int8":
        wq, sc = quantize_crossbar(wf)
    else:
        wq, sc = wf, torch.rand(fl, generator=gen) + 0.5
    x = torch.randn(c, h, w, generator=gen)
    return x.to(dev), wq.to(dev), sc.to(dev)


def _conv_check(x, wq, sc, shape):
    *_, fh, fw, stride, pad = shape
    got = conv2d.crossbar_conv2d(x, wq, sc, stride=stride, pad=pad, fh=fh,
                                 fw=fw)
    want = conv2d.crossbar_conv2d_plain(x, wq, sc, stride, pad, fh, fw)
    torch.cuda.synchronize()
    if got.dtype != torch.float32 or got.shape != want.shape:
        raise AssertionError(f"crossbar_conv2d at {shape}: {got.dtype} "
                             f"{tuple(got.shape)} vs {tuple(want.shape)}")
    atol = 1e-4 * max(1.0, want.abs().max().item())
    err = (got - want).abs().max().item()
    if not torch.isfinite(got).all() or not torch.allclose(
            got, want, rtol=1e-4, atol=atol):
        raise AssertionError(f"crossbar_conv2d disagrees at {shape} "
                             f"{wq.dtype}: max err {err}")
    return got, err


def phase_conv_kernel(dev):
    gen = torch.Generator().manual_seed(14)
    errs = {"int8": 0.0, "f32": 0.0}
    n = 0
    for shape in CONV_SHAPES:
        for wdtype in ("int8", "f32"):
            x, wq, sc = _conv_inputs(shape, wdtype, gen, dev)
            errs[wdtype] = max(errs[wdtype], _conv_check(x, wq, sc, shape)[1])
            n += 1
    # strided x (a transposed view), made contiguous by the wrapper
    x, wq, sc = _conv_inputs(CM_CONV, "int8", gen, dev)
    xt = x.transpose(1, 2).contiguous().transpose(1, 2)
    if xt.is_contiguous():
        raise AssertionError("the strided conv case is contiguous")
    got, err = _conv_check(xt, wq, sc, CM_CONV)
    errs["int8"] = max(errs["int8"], err)
    # Listing 1 per pixel, in numpy, on the same int8 crossbar and scales
    c, fl, fh, fw = CM_CONV[0], *CM_CONV[3:6]
    scn = sc.cpu().numpy()
    flt = wq.cpu().numpy().astype(np.float32).reshape(fl, c, fh, fw)
    want = conv2d_mxv(x.cpu().numpy(), flt, None, CM_CONV[6], CM_CONV[7],
                      lambda m, v: (m @ v) * scn)
    y = got.cpu().numpy()
    listing1_err = float(np.abs(y - want).max())
    np.testing.assert_allclose(
        y, want, rtol=1e-4, atol=1e-4 * max(1.0, float(np.abs(want).max())),
        err_msg="crossbar_conv2d against Listing 1 per pixel")
    print(f"[14] {n + 1} conv kernel-vs-plain cases agree: max abs err "
          f"{errs['int8']:.3g} (int8 wq), {errs['f32']:.3g} (f32 wq); "
          f"against Listing 1 per pixel at {CM_CONV}: {listing1_err:.3g}")
    return dict(max_abs_err=max(errs.values()), errs=errs,
                listing1_err=listing1_err)


def phase_quickstart():
    """The conv kernel's path: the quickstart at the CM main path's width,
    with its launch counts."""
    log = io.StringIO()
    _zero_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        out = quickstart.main(["--device", "cuda"], c=28, img=16)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = _all_counts()
    # its generated LCU table is one line of ~100 KB: cut every line short
    for line in log.getvalue().splitlines():
        print(f"[15]   {line[:150]}")
    _expect(counts, {**{k: 0 for k in counts},
                     "crossbar_conv2d": out["n_convs"]}, "[15] quickstart")
    if out["n_convs"] != 4:
        raise AssertionError(f"quickstart graph has {out['n_convs']} convs")
    print(f"[15] quickstart at c=28, 16x16 in {secs:.2f} s: pipelined "
          f"{out['pipelined_cycles']} cycles, sequential "
          f"{out['sequential_cycles']}; launches {counts}")
    return dict(launches=counts["crossbar_conv2d"], wall_s=secs, **out)


class _CodesPlane(NumpyPlane):
    """The numpy plane on the descriptor's int8 conductances: the values
    ``TorchPlane`` computes with."""

    def mxv_batch(self, desc, V):
        return np.einsum("bn,mn->bm", V,
                         desc.wq.astype(np.float32) * desc.wscale[:, None])

    def mxv_one(self, desc, v):
        return self.mxv_batch(desc, v[None])[0]


def _fault_serve(plane):
    """fig2 under core death, as benchmarks/bench_faults.py serves it, with
    int8-exact weights (so the float planes agree to rounding); ``plane``
    None is the default plane."""
    chip = make_chip(8, "all_to_all")
    pl = place_tenants([build_fig2_graph()], chip, quantizer=dequantize_int8)
    faults = sample_schedule(8, FAULT_HORIZON, core_fault_rate=FAULT_RATE,
                             seed=11)
    server = CmServer(pl, chip, faults=faults, deadline=FAULT_DEADLINE,
                      retry=FAULT_RETRY, quantizer=dequantize_int8,
                      **({} if plane is None else {"compute_plane": plane}))
    rng = np.random.default_rng(0)
    images = [rng.normal(size=(4, 8, 8)).astype(np.float32)
              for _ in range(6)]
    t0 = time.perf_counter()
    rep = server.serve_images(images, arrivals=[i * 40 for i in range(6)])
    torch.cuda.synchronize()
    return rep, time.perf_counter() - t0, server


class _CountTorchPlane:
    """Count ``TorchPlane.mxv_batch`` calls of every instance (the server
    builds a new default plane when a remap rebuilds its simulator)."""

    def __init__(self):
        self.calls = 0
        self.devices = set()

    def __enter__(self):
        self._inner = inner = TorchPlane.mxv_batch

        def counted(plane, desc, V):
            self.calls += 1
            self.devices.add(str(plane.device))
            return inner(plane, desc, V)
        TorchPlane.mxv_batch = counted
        return self

    def __exit__(self, *exc):
        TorchPlane.mxv_batch = self._inner


def _same_serve(ref, rep, what):
    if rep.to_json() != ref.to_json():
        raise AssertionError(f"{what}: serve reports differ")
    worst = 0.0
    for a, b in zip(ref.requests, rep.requests):
        if a.succeeded != b.succeeded:
            raise AssertionError(f"{what}: request {a.rid} verdicts differ")
        for v in (a.output or {}):
            if b.output[v].shape != a.output[v].shape or \
                    not np.isfinite(b.output[v]).all():
                raise AssertionError(f"{what}: bad output {v}")
            worst = max(worst, _float_tol(a.output[v], b.output[v], v))
    return worst


def phase_fault_serve(dev):
    ref, numpy_s, _ = _fault_serve(NumpyPlane())
    _zero_counts()
    with _CountTorchPlane() as cnt:
        rep, torch_s, server = _fault_serve(None)
    launches = _all_counts()
    if not (isinstance(server.sim.plane, TorchPlane)
            and cnt.devices == {str(dev)}):
        raise AssertionError(f"fault serve ran on {server.sim.plane!r}, "
                             f"{cnt.devices}, not the card")
    if not 0 < launches["crossbar_mxv"] == cnt.calls:
        raise AssertionError(f"fault serve: {launches['crossbar_mxv']} "
                             f"launches for {cnt.calls} plane calls")
    ok_remaps = [e for e in rep.remap_events if e["ok"]]
    if not ok_remaps or rep.n_retries == 0 or rep.goodput < 1.0:
        raise AssertionError(f"fault serve did not recover: remaps "
                             f"{rep.remap_events}, retries {rep.n_retries}, "
                             f"goodput {rep.goodput}")
    worst = _same_serve(ref, rep, "[16] fault serve")
    kw = dict(stuck_fraction=0.01, drift_sigma=0.02)
    fref, _, _ = _fault_serve(FaultyPlane(inner=_CodesPlane(), **kw))
    _zero_counts()
    with _CountTorchPlane() as fcnt:
        frep, _, _ = _fault_serve(FaultyPlane(inner=TorchPlane(dev), **kw))
    flaunches = _all_counts()
    if not 0 < flaunches["crossbar_mxv"] == fcnt.calls:
        raise AssertionError(f"faulty-plane serve: "
                             f"{flaunches['crossbar_mxv']} launches for "
                             f"{fcnt.calls} plane calls")
    fworst = _same_serve(fref, frep, "[16] FaultyPlane serve")
    nref, _, _ = _fault_serve(FaultyPlane(inner=NumpyPlane(), **kw))
    quant = max((float(np.abs(a.output[v] - b.output[v]).max())
                 for a, b in zip(nref.requests, frep.requests)
                 for v in (a.output or {})), default=0.0)
    # wall time in turns, after the checked runs (numpy, torch); timing
    # runs, so their launches do not count
    before = _all_counts()
    turns = []
    for name in ("torch", "numpy", "numpy", "torch"):
        turns.append((name, _fault_serve(
            NumpyPlane() if name == "numpy" else None)[1]))
    _set_counts(before)
    print(f"[16] fault serve (fig2, core_fault_rate {FAULT_RATE}): goodput "
          f"{rep.goodput}, {rep.n_retries} retries, remap events "
          f"{rep.remap_events}, reprogram cycles {rep.reprogram_cycles}, "
          f"makespan {rep.makespan}; reports equal to NumpyPlane's; worst "
          f"output err {worst:.3g}; {cnt.calls} plane calls = crossbar_mxv "
          f"launches")
    print(f"[16] FaultyPlane over TorchPlane: reports equal, worst output "
          f"err {fworst:.3g} against the int8-conductance numpy plane "
          f"({fcnt.calls} launches); {quant:.3g} against plain NumpyPlane "
          f"(the drifted crossbar's int8 quantization)")
    print(f"[16] fault serve wall ms: checked runs numpy {numpy_s * 1e3:.1f}, "
          f"torch {torch_s * 1e3:.1f}; in turns " + ", ".join(
              f"{n} {t * 1e3:.1f}" for n, t in turns))
    return dict(goodput=rep.goodput, n_retries=rep.n_retries,
                remap_events=rep.remap_events,
                reprogram_cycles=rep.reprogram_cycles, makespan=rep.makespan,
                plane_calls=cnt.calls, launches=launches["crossbar_mxv"],
                worst_err=worst, faulty_worst_err=fworst,
                faulty_vs_numpy_inner_err=quant,
                wall_ms_turns=[[n, t * 1e3] for n, t in turns])


def phase_analyze():
    out = {}
    for name, graph in (("main", build_resnet_block_chain(2, c=28, img=16)),
                        ("lenet28", build_lenet_like(img=28))):
        chip = make_chip(8, "banded")
        t0 = time.perf_counter()
        prog = compile_model(graph, chip, quantizer=dequantize_int8,
                             analyze=True)
        compile_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        rep = verify_program(prog, chip)
        verify_ms = (time.perf_counter() - t0) * 1e3
        if rep.errors() or rep.metrics["deps_checked"] == 0:
            raise AssertionError(f"[17] {name}: {rep.summary()}")
        out[name] = dict(compile_s=compile_s, verify_ms=verify_ms,
                         warnings=len(rep.warnings()),
                         deps_checked=rep.metrics["deps_checked"])
        print(f"[17] {name}: compile_model(analyze=True) {compile_s:.2f} s, "
              f"verify_program {verify_ms:.1f} ms: {rep.summary()}, "
              f"{rep.metrics['deps_checked']} deps checked")
    # saturate one frontier table's ranks (a copy: tables are shared)
    for cfg in prog.cores.values():
        dep = next((d for lc in cfg.lcu.values() for d in lc.deps
                    if d.table is not None and not d.table.never_constrains),
                   None)
        if dep is not None:
            break
    rank = dep.table.rank.copy()
    rank[rank >= 0] = dep.table.d_lexmax_rank
    dep.table = dataclasses.replace(dep.table, rank=rank)
    bad = verify_program(prog, chip)
    if bad.ok or "frontier-unsound" not in bad.checks():
        raise AssertionError(f"[17] corrupted table not caught: "
                             f"{bad.summary()} {bad.checks()}")
    print(f"[17] a saturated frontier table on lenet-28 is caught: "
          f"{bad.checks()}")
    return out


def _conv_bound(c, h, w, fl, fh, fw, stride, pad, welem):
    """Each input read once, y written once; 2 operations per term and one
    multiply per output for the scale."""
    oh = (h + 2 * pad - fh) // stride + 1
    ow = (w + 2 * pad - fw) // stride + 1
    k = c * fh * fw
    nbytes = c * h * w * 4 + fl * k * welem + fl * 4 + fl * oh * ow * 4
    ops = 2 * fl * oh * ow * k + fl * oh * ow
    t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS["f32"] * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def phase_conv_times(dev):
    gen = torch.Generator().manual_seed(18)
    c, h, w, fl, fh, fw, stride, pad = CM_CONV
    x, wq, sc = _conv_inputs(CM_CONV, "int8", gen, dev)
    w4 = (wq.float() * sc[:, None]).reshape(fl, c, fh, fw)
    kern = lambda: conv2d.crossbar_conv2d(x, wq, sc, stride=stride, pad=pad,
                                          fh=fh, fw=fw)
    before = _all_counts()
    ms = _events_ms(kern)
    dev_us = _device_us(kern, "crossbar_conv2d_kernel")
    _set_counts(before)
    plain_ms = _events_ms(lambda: conv2d.crossbar_conv2d_plain(
        x, wq, sc, stride, pad, fh, fw))
    lib = lambda: torch.nn.functional.conv2d(x[None], w4, stride=stride,
                                             padding=pad)
    lib_ms = _events_ms(lib)
    lib_dev_us = _device_total_us(lib, "[18] F.conv2d")
    bound_ms, bound_by = _conv_bound(*CM_CONV, 1)
    oh = (h + 2 * pad - fh) // stride + 1
    ow = (w + 2 * pad - fw) // stride + 1
    plan = conv2d.conv_plan(c, fl, fh, fw, stride, oh, ow)
    print(f"[18] crossbar_conv2d at {CM_CONV} int8: {ms * 1e3:.2f} us per "
          f"launch (events, back to back), device {_us(dev_us)}; plain "
          f"{plain_ms * 1e3:.2f} us; F.conv2d (cuDNN, f32) "
          f"{lib_ms * 1e3:.2f} us, device {_us(lib_dev_us)}; bound "
          f"{bound_ms * 1e3:.4f} us ({bound_by}); launch plan computed by "
          f"conv_plan: {plan}")
    return dict(ms=ms, dev_us=dev_us, plain_ms=plain_ms, lib_ms=lib_ms,
                lib_dev_us=lib_dev_us, bound_ms=bound_ms, bound_by=bound_by)


def conv_kernel_row(errs, qs, times, faults, analyze):
    return {
        "name": "crossbar_conv2d", "route": "cuda", "source": CONV_SOURCE,
        "replaces": REPLACES["crossbar_conv2d"], "launches": qs["launches"],
        "max_abs_err": errs["max_abs_err"], "ms": times["ms"],
        "plain_ms": times["plain_ms"], "bound_ms": times["bound_ms"],
        "bound_by": times["bound_by"], "library_ms": times["lib_ms"],
        "shape": list(CM_CONV) + ["int8"],
        "device_ms": _ms(times["dev_us"]),
        "library_device_ms": _ms(times["lib_dev_us"]),
        "max_abs_err_listing1": errs["listing1_err"],
        "quickstart": {k: qs[k] for k in ("n_convs", "pipelined_cycles",
                                          "sequential_cycles", "wall_s")},
        "fault_serve": faults, "analyze": analyze,
    }


# ------------------------------------------------------ tuned CM programs
TUNED = ("lenet", "resnet4")


def _plain(v):
    """A dataclass as nested dicts and lists, to compare every field."""
    if dataclasses.is_dataclass(v):
        return {f.name: _plain(getattr(v, f.name))
                for f in dataclasses.fields(v)}
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    return v


def _tuned_run(prog, chip, images, plane):
    """The tuner's own run of a program (event engine, pipelined, stalls
    on) on ``plane``; (outputs, stats, (B, N, M) -> calls, launches)."""
    shapes = collections.Counter()
    _count_calls(plane, shapes)
    sim = Simulator(prog, chip, check_raw=False, engine="event",
                    compute_plane=plane)
    _zero_counts()
    outs, stats = sim.run(images, schedule="pipelined", stalls=True)
    torch.cuda.synchronize()
    return outs, stats, shapes, _all_counts()


def phase_tuned(dev):
    """[19] The committed autotuned programs on the card: the recorded
    searches regenerate their artifacts under Z3's mapper (the CPU tests
    hold them under the backtracking one), the tuned programs simulate on
    ``TorchPlane`` to the artifacts' cycles with the numpy plane's
    counters, and ``CmServer`` serves them and the baseline configs.
    Returns each program's kernel launches by plane kind ("float", "dac")."""
    from repro_torch.core import mapping, poly
    from repro_torch.tune import TuneConfig, ZOO, load_tuned
    from repro_torch.tune.__main__ import main as tune_main
    out = {}
    # the CPU tests reproduce the artifacts with the backtracking mapper;
    # where Z3 is installed the searches map with it, so check them again
    backends = (f"mapper {'z3' if mapping.HAVE_Z3 else 'backtracking'}, "
                f"polyhedral backend {'islpy' if poly.HAVE_ISL else 'fisl'}")
    for name in TUNED:
        out[name] = {}
        if not mapping.HAVE_Z3:
            print(f"[19] tune --check {name}: not run ({backends}, the "
                  f"CPU tests' mapper)")
            continue
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as log:
            rc = tune_main(["--model", name, "--check"])
        secs = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"[19] tune --check {name}: rc {rc}\n"
                                 f"{log.getvalue()}")
        print(f"[19] python -m repro_torch.tune --model {name} --check: "
              f"rc 0 in {secs:.2f} s of host time ({backends}); "
              f"{log.getvalue().splitlines()[0]}")
    for name in TUNED:
        entry, art = ZOO[name], load_tuned(name)
        graph, chip = entry.build(), entry.chip()
        prog = compile_model(graph, chip, tune=name,
                             quantizer=dequantize_int8)
        shp = tuple(int(x) for x in graph.values[graph.inputs[0]].shape)
        rng = np.random.default_rng(entry.workload.seed)   # the tuner's
        images = [rng.normal(size=shp).astype(np.float32)
                  for _ in range(entry.workload.n_images)]
        ref, rstats, _, _ = _tuned_run(prog, chip, images, NumpyPlane())
        planes = [("float", TorchPlane(dev), "crossbar_mxv", _float_tol)]
        if name == "lenet":
            planes.append(("dac", TorchPlane(dev, dac=True),
                           "crossbar_mxv_int8", _dac_tol))
        res = out[name]
        n_chips = 1 if prog.mesh is None else prog.mesh.n_chips
        for kind, plane, kname, tol in planes:
            if plane.device.type != "cuda":
                raise AssertionError(f"[19] {name}: {plane!r} not on the card")
            got, stats, shapes, launches = _tuned_run(prog, chip, images,
                                                      plane)
            what = f"[19] {name} {kind}"
            if stats.cycles != art["cycles"]:
                raise AssertionError(f"{what}: {stats.cycles} cycles, the "
                                     f"artifact records {art['cycles']}")
            want, have = _plain(rstats), _plain(stats)
            differ = [f for f in want if want[f] != have[f]]
            if differ:
                raise AssertionError(f"{what}: SimStats {differ} differ "
                                     f"from the numpy plane's")
            worst = 0.0
            for a, b in zip(ref, got):
                for v in a:
                    if b[v].shape != a[v].shape or not np.isfinite(b[v]).all():
                        raise AssertionError(f"{what}: bad output {v}")
                    worst = max(worst, tol(a[v], b[v], v))
            calls = sum(shapes.values())
            others = {k: n for k, n in launches.items() if k != kname and n}
            if not 0 < launches[kname] == calls or others:
                raise AssertionError(f"{what}: {launches[kname]} {kname} "
                                     f"launches for {calls} plane calls; "
                                     f"other launches {others}")
            res[kind] = launches[kname]
            print(f"{what}: {stats.cycles} cycles (artifact "
                  f"{art['cycles']}) on {n_chips} chip(s), "
                  f"{len(prog.cores)} cores; SimStats equal to NumpyPlane's; "
                  f"worst output err {worst:.3g}; {calls} plane calls = "
                  f"{kname} launches")
            print(f"{what} (B, N, M) -> calls: " + ", ".join(
                f"{k}:{v}" for k, v in sorted(shapes.items())))
        # serves of 8 Poisson requests (phase 3's), tuned and baseline in
        # turns; timing runs: each checked on the card, launches not kept
        base = compile_model(graph, chip, quantizer=dequantize_int8,
                             tune=TuneConfig.from_json_dict(
                                 art["baseline"]["config"]))
        rng = np.random.default_rng(0)
        simgs = [rng.normal(size=shp).astype(np.float32) for _ in range(8)]
        arrivals = poisson_arrivals(8, rate=0.002, seed=7)
        turns, cycles = [], {}
        for which in ("tuned", "baseline", "baseline", "tuned"):
            _zero_counts()
            rep, shapes, secs, plane = _serve(
                prog if which == "tuned" else base, chip, simgs, arrivals,
                None)
            if not (isinstance(plane, TorchPlane)
                    and plane.device.type == "cuda") or \
                    not 0 < _all_counts()["crossbar_mxv"] == \
                    sum(shapes.values()):
                raise AssertionError(f"[19] {name} {which} serve: not every "
                                     f"plane call launched on the card")
            turns.append([which, secs * 1e3])
            cycles[which] = int(rep.stats.cycles)
        wall_ms, busy_ms, _, _ = _device_busy(
            lambda: _serve(prog, chip, simgs, arrivals, None))
        _zero_counts()
        busy = "device busy not measured" if busy_ms is None else (
            f"device busy {busy_ms:.3f} ms, idle share "
            f"{1 - busy_ms / wall_ms:.4f}")
        print(f"[19] {name} CmServer, 8 requests: wall ms in turns " +
              ", ".join(f"{w} {ms:.1f}" for w, ms in turns) +
              f"; cycles tuned {cycles['tuned']}, baseline "
              f"{cycles['baseline']}; profiled tuned serve: wall "
              f"{wall_ms:.1f} ms, {busy}")
    return out


def _timed(fn, *args, **kw):
    """``fn(*args, **kw)``, with its wall seconds printed (a model's build
    and free included where ``fn`` does them)."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    label = " ".join([fn.__name__] + [a for a in args if isinstance(a, str)])
    print(f"[wall] {label}: {time.perf_counter() - t0:.1f} s")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card and "
              "has no CPU mode", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t_start = time.perf_counter()
    _timed(phase_build)
    errs = _timed(phase_kernels, dev)
    paths = {
        "main": _timed(phase_serve, "main",
                       build_resnet_block_chain(2, c=28, img=16), None,
                       _float_tol),
        "dac": _timed(phase_serve, "dac", build_lenet_like(img=28),
                      {"device": dev, "dac": True}, _dac_tol),
    }
    main_calls, main_l = paths["main"]["calls"], paths["main"]["launches"]
    if not 0 < main_l["crossbar_mxv"] == main_calls:
        raise AssertionError(f"main path: {main_l['crossbar_mxv']} float "
                             f"launches for {main_calls} plane calls")
    if main_l["crossbar_mxv_int8"] != 0:
        raise AssertionError("main path launched the int8 kernel")
    dac_l = paths["dac"]["launches"]
    if not 0 < dac_l["crossbar_mxv_int8"] == paths["dac"]["calls"]:
        raise AssertionError(f"DAC path: {dac_l['crossbar_mxv_int8']} int8 "
                             f"launches for {paths['dac']['calls']} calls")
    kernels = _timed(phase_times, dev, paths, errs)
    attn_errs = _timed(phase_attention_kernels, dev)
    t0 = time.perf_counter()
    model = build_model(get_arch(LM_ARCH), dev, seed=0)
    torch.cuda.synchronize()
    print(f"[7] {LM_ARCH}: {sum(p.numel() for p in model.parameters())} "
          f"parameters initialised on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    shapes = _ShapeLog()
    serve = _timed(phase_lm_serve, model, shapes)
    prompts, req_prompts = _lm_workload(model.cfg.vocab_size)
    graph_runs = {kv: _timed(
        phase_graph_vs_eager, f"{LM_ARCH} kv={kv}", _lm_cfg(kv), model,
        prompts, NEW, req_prompts if kv == "compute" else None)
        for kv in ("compute", "int8")}
    lm_paths = _timed(phase_lm_paths, dev, model)
    times = _timed(phase_lm_times, dev, model, serve, shapes)
    kernels += attention_kernel_rows(attn_errs, serve, times, lm_paths,
                                     graph_runs)
    del model, shapes
    _free()
    scan_errs = _timed(phase_scan_kernel, dev)
    fm = _timed(_build_full, MAMBA_ARCH, dev)
    fm_serve = _timed(phase_mamba_serve, fm)
    fm_prompts, fm_reqs = _lm_workload(fm.cfg.vocab_size)
    fm_serve["graph_vs_eager"] = _timed(
        phase_graph_vs_eager, MAMBA_ARCH, fm.cfg, fm, fm_prompts, NEW,
        fm_reqs)
    fm_paths = _timed(phase_paths, dev, MAMBA_ARCH, fm, NEW,
                      MAMBA_BF16_LOGIT_BOUND, 10)
    fm_times = _timed(phase_mamba_times, dev, fm)
    del fm
    _free()
    qm = _timed(_build_full, MOE_ARCH, dev)
    moe = _timed(phase_moe, dev, qm)
    del qm
    _free()
    hybrid = _timed(phase_hybrid, dev)
    kernels.append(scan_kernel_row(scan_errs, fm_serve, fm_paths, fm_times,
                                   moe, hybrid))
    families = {arch: _timed(phase_family, dev, arch)
                for arch in (VLM_ARCH, ENCDEC_ARCH)}
    family_kernel_cells(kernels, families,
                        _timed(_family_kernel_times, dev))
    bwd = _timed(phase_attention_bwd, dev)
    fwd_lse = bwd["times"][torch.bfloat16]
    next(row for row in kernels if row["name"] == "flash_attention").update(
        ms_with_lse=fwd_lse["fwd_lse_ms"],
        device_ms_with_lse=_ms(fwd_lse["fwd_lse_dev_us"]))
    full = _timed(phase_train_full, dev)
    smoke = _timed(phase_train_smoke, dev)
    kernels += train_kernel_rows(bwd, full, smoke)
    kernels.append(adamw_kernel_row(full, smoke))
    t23 = time.perf_counter()
    scan_bwd = _timed(phase_scan_bwd, dev)
    trained = {"falcon_mamba": _timed(phase_train_mamba, dev),
               "qwen2_moe": _timed(phase_train_moe, dev),
               "qwen2_moe_f32_routing": _timed(phase_moe_f32_routing, dev),
               "seamless": _timed(phase_train_encdec, dev),
               "jamba_smoke": _timed(phase_train_hybrid, dev)}
    row = scan_bwd_kernel_row(scan_bwd, trained["falcon_mamba"],
                              trained["jamba_smoke"])
    row["training"] = trained
    kernels.append(row)
    print(f"[wall] phase 23: {time.perf_counter() - t23:.1f} s")
    conv_errs = _timed(phase_conv_kernel, dev)
    qs = _timed(phase_quickstart)
    faults = _timed(phase_fault_serve, dev)
    analyze = _timed(phase_analyze)
    conv_times = _timed(phase_conv_times, dev)
    kernels.append(conv_kernel_row(conv_errs, qs, conv_times, faults,
                                   analyze))
    tuned = _timed(phase_tuned, dev)
    for row in kernels:              # the crossbar rows: launches by path
        kind = {"crossbar_mxv": "float",
                "crossbar_mxv_int8": "dac"}.get(row["name"])
        if kind is not None:
            row["launches_by_path"] = {
                f"tuned_{name}": tuned[name][kind]
                for name in TUNED if kind in tuned[name]}
    print(f"[wall] every phase: {time.perf_counter() - t_start:.1f} s")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
