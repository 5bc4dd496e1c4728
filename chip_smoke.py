#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths on one NVIDIA card: the device echo
path (K1), directly and as RPC through the port's Server and Channel over
TCP and over the two-party device link (with the quantized pmean device
method, K2, over the link) and fanned out by the combo channels over load
balancers and naming, streaming RPC, the link whose halves live in two
processes (device RPC over it in a worker process), the collective
session plane over RPC in one process and across processes (K2), the
FabricNet train step with ring attention (K3), its
elementwise chain (K4) and the rest of what XLA fuses around its matrix
products (K4e: the SGD update, the MoE's gate and combine, the loss), in
the fused and the sliced schedules, the step with heads = 0 and its ring
mean (K4f), the step on the fabric mesh with all 8 ranks on the card (tp
psum, pp GPipe, sp ring attention and ring mean, ep all_to_all), and the
quantized collective sessions (K2).

    python3 chip_smoke.py [--out FILE]
    python3 chip_smoke.py --k2-only ROOT [--out FILE]   # phase 11 alone, the port under ROOT

Run from the repository root on a machine with a CUDA card. It builds the
port's kernels from ``incubator_brpc_tpu_torch/csrc`` (into
``incubator_brpc_tpu_torch/_build/``) and then, failing on the first fault:

1. prints the card (``nvidia-smi`` name and power limit), the build time,
   and each K3, K4 and K2 kernel's registers and spills from ptxas's report
   (K2: both forms of each kernel);
2. holds each kernel — K1a ``frame_rows``, K1b ``verify_rows``, K1c
   ``echo_step_rows`` — against its plain PyTorch version on the card,
   bit for bit, at every geometry of the main path, with rows that carry a
   bad magic, a bad length, a flipped payload word and an unknown method id,
   and times kernel, plain version and a ``copy_`` of the same bytes behind
   a spin kernel (``device_ms``), and the kernel back to back through its
   wrapper (``time_ms``, the rate the RPC path sees);
3. drives the endpoint path with the launch counts set to zero: a
   ``DeviceEndpoint`` with the default echo table (16 threads x 8 calls of
   256 B, then 20 sequential calls), one with methods {0: echo, 3: x2,
   5: +10} (the same traffic mixed with an unknown method, a burst of 16
   calls of 32 KiB, one call at the largest bucket of 2^24 words), and one
   ``make_echo_step`` step of 2^26 words; every response and error code is
   checked, and every kernel must have launched;
3b. drives device RPC, the path a user calls, with the launch counts set to
   zero: ``DeviceEndpoint.server_handler()`` (window 16) mounted on the
   port's ``Server`` and called through the port's ``Channel`` on loopback
   at ``bench_device_rpc``'s geometry: a warm-up, 20 sequential calls of
   256 B (µs a call, beside the endpoint's own: their difference is the
   host plane's cost; also the time inside the server's handler and a
   host-only echo over the same Server and Channel), 16 threads x 8 calls
   (calls/s; the host-only echo's too), the mixed table
   {0, 3, 5, 999} through a second service, a burst of 16 calls of 32 KiB
   and one call of 2^23 words (the largest whose frame fits
   ``max_body_size``); every response and error code is checked and K1a,
   K1b and K1c must have launched; torch.profiler over the pipelined
   16 x 8 burst gives wall time, device busy time and the idle share; and
   the host's time to pack a 32 KiB frame with and without the
   body-checksum bit (CRC32C of the port's host runtime);
3c. drives the two-party device link (``transport="tpu"``), both parties
   on the card, with the launch counts set to zero around each part: (a) a
   1 KiB echo (``usercode_inline=True``), a warm call then 200 in a row
   over the link, beside the same 200 over TCP on the same server (one
   link, the same object across calls); (b) device RPC over the link on a
   second server (``usercode_inline=False``): 20 sequential 256 B calls,
   16 threads x 8 calls of the mixed table {0, 3, 5, 999} and one call of
   2^20 words (4 MiB, 64 default slots), every answer bitwise
   ``expected()``, K1a, K1b and K1c launched; (c) ``device_method()``
   around the int8 quantized pmean kernel (width 4096, block 32) over the
   link, each answer bitwise ``np_quantized_pmean`` at one party, one K2a
   and one K2b a call; (e) ``server.stop()`` fails the client's link, and
   with the server started again on its port the next call re-handshakes a
   fresh link; (d) the link stream at ``bench_device_link``'s geometry
   (1 MiB slots, window 8, 256 MiB in 1 MiB sends) in the host swap and
   the forced device form (``host_loopback=False``, each step's slots
   swapped on the card), in ack modes "local" and "wire": a checked run of
   each (the delivered bytes' CRC-32 equals the sent one), then 3 runs
   each in alternating order (GB/s), and one forced-form run under
   torch.profiler (device busy time and idle share);
3d. drives the combo channels and load balancers over device links, five
   servers on the card (each the echo table and methods {0, 3, 5} through
   ``DeviceEndpoint.server_handler()``, the quantized pmean device method
   and a counted echo), with the launch counts set to zero around each
   part: (a) a ParallelChannel over 4 servers, ``transport="tpu"`` and TCP:
   20 sequential fan-outs of 256 B (µs a fan-out), 16 threads x 8
   fan-outs (fan-outs/s), every merged answer the four ``expected()`` in
   channel order, torch.profiler over a burst (idle share), K1a and K1c
   launched; (b) a PartitionChannel from ``list://`` with ``i/4`` tags over
   the quantized pmean device method: four copies of the numpy twin's
   bytes a fan-out, exactly four K2a and four K2b launches a fan-out; (c)
   ``Channel.init("list://a,b,c", lb, transport="tpu")``: ``rr`` gives 20
   of 60 calls to each server, ``la`` the fewest to the server slowed by a
   fixed sleep; (e) a DynamicPartitionChannel with a 3- and a 2-partition
   scheme: both serve, bitwise; (d) a SelectiveChannel over 3 servers, one
   stopped mid-run: every call answered. All sub-links share the card, so
   each takes the host swap and the fused lowering does not arise;
3e. drives streaming RPC and the multi-controller link across processes
   (``mc_phase``): (a) a stream of ``STREAM_MSGS`` seeded messages of 1 KiB
   to 1 MiB (window ``STREAM_MAX_BUF``, below their total, so the writer
   parks) over TCP and over a ``transport="tpu"`` link in the forced device
   form on cuda:0, each message's length and CRC-32 checked in order at
   the server, messages/s and MB/s, two runs each in turns; (b)
   ``transport/mc_worker.py``'s two-process pair, both processes on cuda:0
   over gloo (NCCL refuses two ranks on one card): 8 echoes of 3000 B and
   20 device RPCs of the echo table (``DeviceEndpoint.server_handler()`` in
   the server process, whose K1a and K1c launches it reports and this
   asserts), the windowed burst (4 x 20000 B, 128-word slots, window 2,
   over 160 steps), both halves of each link at one final step count with
   their slot rows CUDA tensors (``halves_agree``); steps, ``peer_ack``,
   ``final_target``, ms an echo, steps/s and host ms an exchange; and the
   probe's gloo exchange of cuda:0 rows against host rows at 256 and
   16,384 slot words (the staging); (c) the three-process fabric, a
   PartitionChannel over two multi links; (d) peer death: the server
   process exits inside a call, which fails with EFAILEDSOCKET (its
   duration printed);
3f. drives the port's native host runtime (``native_phase``): (a) g++
   builds ``csrc/host`` into a scratch file (the compiler, the seconds,
   whether ``zlib.h`` was found; a failed build fails the phase with its
   log), and the runtime's CRC32C, CRC32, FlatMap, ResourcePool, IOBuf cut
   and tbus_std pack and cut are held against their plain twins on seeded
   data; (b) ``bench_native_plane``'s and ``bench_native_scaling``'s host
   echo through the port's API beside the host's CPU count: 64 B
   sequential (3000 calls x 5) through ``ChannelOptions(native_plane=
   True)``, 8 threads x 2000 calls, ``NativeClientChannel.pump`` of 2000 at
   64 in flight, a 32 KiB echo's GB/s, and the pump sweep at 1, 2 and 4
   reactors over 1, 2 and 4 connections; (c) phase 3b's device RPC (256 B,
   window 16), one ``DeviceEndpoint.server_handler()`` behind the Python
   plane and a native-plane Server (from the port's Python Channel and its
   native client) and a native-plane Server running the handler on its
   reactor (native client), in turns: 20 sequential calls each (and the
   time inside the handler), 16 x 8 each but the inline server's (every
   answer bitwise ``expected()``), torch.profiler's idle share of a native
   burst, K1 tallied per configuration and K1a and K1c launched on the
   native plane (the counts set to zero before), beside phase 3b's;
3g. drives the server and channel policies (``policy_phase``) around
   ``DeviceEndpoint.server_handler()`` at phase 3b's geometry (256 B,
   window 16), the launch counts set to zero before and K1 tallied per
   part, every admitted reply bitwise ``expected()``: (a)
   ``ServerOptions(max_concurrency="auto")`` under a serial baseline, a
   flood of 64 callers (4x the window) and a serial tail: no ELIMIT in the
   baseline, ELIMIT in the flood, the limit settled in the tail; the
   limit's trajectory, ELIMIT's count and share, the admitted calls'
   p50/p99 inside the handler and calls/s; (b) ``method_max_concurrency``
   8: eight calls held in the handler admitted, the ninth ELIMIT; (c) a
   native-plane server with ``max_concurrency="auto"``: the limit seeded
   into the C++ table and moved there by the telemetry drain's completions
   of a native-client flood of ``native_echo`` alone (its ELIMIT counted);
   (d) ``enter_lame_duck`` with 16 calls in flight: each answers code 0, a
   new call gets ELOGOFF, the drain thread ends (the drain time); (e)
   ``ChannelOptions(backup_request_ms=5)`` over ``list://`` and ``rr`` to
   two servers, one slowed 30 ms by a ``FaultInjector``: the backups that
   fired and won, p50 and p99 with and without the backup; (f) a
   ``TokenAuthenticator`` on a Python-plane and a native-plane server
   (right token answers, wrong and missing ERPCAUTH) and a device link
   whose handshake presents it. K1a and K1c must launch in (a), (d) and
   (e); the kernels line's K1 entries carry the tallies as
   ``policy_launches``;
3h. drives the device echo over the wires of ROADMAP A11a
   (``protocol_phase``) at phase 3b's geometry (256 B, window 16), the
   launch counts tallied per part, every answer bitwise ``expected()``:
   (a) baidu_std on the Python plane (20 sequential calls, 16 x 8); (b)
   baidu_std behind the native plane from ``Channel(native_plane=True,
   protocol="baidu_std")`` and from ``NativeClientChannel(protocol=
   "baidu_std")``, in turns with (a); (c) ``bench_prpc_production``'s rows
   on the native plane (pumps of 4 KiB plain, snappy over compressible and
   random bytes, token-authenticated: ``cb_frames`` 0 after every flood)
   and the snappy echo through the channel natively and on the pure-Python
   plane; (d) ``POST /tensor/echo`` on the HTTP gateway, ``ChannelOptions(
   protocol="http")`` (also on the native plane's port, handed off), and a
   json2pb typed service answering a curl-style JSON POST, checked field by
   field. K1a and K1c must launch in (a), (b) and (d); the kernels line's
   K1 entries carry the tallies as ``protocol_launches``;
3i. drives the device echo with ``enable_rpcz`` on (``rpcz_phase``, every
   span kept), the launch counts tallied per part: (a) over tbus_std on the
   Python plane, each call's client span and server span held linked (one
   trace, the server's parent the client's span, annotated "processing");
   (b) baidu_std behind the native plane from ``Channel(native_plane=True)``
   (linked alike) and ``NativeClientChannel`` with its own trace, then a
   ``native_echo`` flood whose telemetry drain leaves exactly one sampled
   span in ``RPCZ_SAMPLE_EVERY``; (c) ``POST /tensor/echo``, a gateway span
   a call; (d) ``/rpcz`` (also by trace id), ``/vars``, ``/vars.json``,
   ``/brpc_metrics`` (the exposition validated line by line), ``/status``,
   ``/flags``, ``/connections`` and ``/sockets`` over the port's HTTP
   channel, ms a scrape; (e) µs a device echo with rpcz off and on in
   mirrored turns (the span cost) and spans/s under a 16 x 8 burst; (f)
   ``/hotspots/contention`` naming a contended ``FiberMutex`` loop. K1a and
   K1c must launch in (a), (b), (c) and (e); the kernels line's K1 entries
   carry the tallies as ``rpcz_launches``;
4. times ``make_echo_step`` at 256 and 2^26 words with CUDA events;
5. holds K3 (the forward fold, dK/dV and dQ, on the tensor cores for bf16
   operands, ``attn_fold_fwd_tc``, ``attn_bwd_dkdv_tc`` and
   ``attn_bwd_dq_tc``; for f32 the fold, dK/dV and dQ on the tensor cores
   in 3xTF32, ``attn_fold_fwd_tf32``, ``attn_bwd_dkdv_tf32`` and
   ``attn_bwd_dq_tf32``; ``attn_bwd_delta`` for both)
   against its plain
   versions at the bench attention shape (B 4, T 1024, H 2, D 1024; sp 1
   and 4; bf16 and f32; causal and not), two ragged ones (B 2, T 48, H 4,
   D 16, sp 4; B 1, T 200, H 2, D 144, sp 2) and two off the tensor cores'
   k-step (B 2, T 72, H 2, D 24 and D 20, sp 2), in any layout (transposed
   views and tensors one element off 16-byte alignment give bitwise what
   contiguous copies give, and dK/dV and dQ on the misaligned ones within
   the tolerances of their plain versions), D 18 (padded to 20 by the
   wrappers), ``attn_bwd_delta`` at ``DELTA_DS`` (D 4 to 4096 on 333 rows;
   each launch in the form ``delta_form`` names, the general form beside
   the vector one, a vector launch off its alignments refused), and
   ``ring_attention`` against ``full_attention`` on the card; then K4
   (``add_rms_norm_fwd`` with and without delta, ``rms_norm_bwd`` with and
   without the residual gradient, ``gelu_tanh_fwd``, ``gelu_tanh_bwd``)
   against its plain versions in bf16
   and f32 at the bench_fabricnet shapes ((4096, 2048), (4096, 8192),
   (2, 2048, 2048)) and at odd widths (d 33 and 1000, contiguous and one
   element off 16-byte alignment): K4a within ``NORM_TOL``, K4b bit for
   bit, K4c and K4d bit for bit but for elements within
   ``TRANSCENDENTAL_ULPS`` (the card's tanhf against the plain version's),
   counted, and K4a on both sides of the widths it keeps in registers
   (``K4A_CAP``); then K4e: ``sgd_update_multi`` bit for bit
   against ``sgd_update_plain`` in each mode (fused, accumulate, the last
   slice of 2 and of 3) in bf16 and f32, over the bench_fabricnet leaves,
   a table mixing leaf sizes 1, 2048 and 2^24 + 3 and alignments, and 70
   leaves (two launches a call), with an f32 element that only one
   rounding gets right; ``moe_combine_fwd`` / ``_bwd`` and
   ``mse_loss_fwd`` at the bench shapes, a slice's and odd ones
   (contiguous and one element off alignment): the combine's d_yr and
   d_logit and the loss's d_out bit for bit, its gate and out bit for bit
   but for elements within ``TRANSCENDENTAL_ULPS`` (expf), the loss within
   ``MSE_TOL``, the differing elements counted, the loss bitwise on a
   rerun; then K4f (``ring_mean_add_fwd`` with delta and without,
   ``ring_mean_add_bwd``) bit for bit against its plain versions in bf16
   and f32 at ``K4F_CASES``: the bench width (4, 1024, 2048), a ragged T,
   an odd d, inputs one element off 16-byte alignment, and a T whose
   column tile does not fit in shared memory; and K4f's sp form (the sp
   ring's mean, ``ring_mean_add_fwd`` / ``_bwd`` with ``sp``) bit for bit
   at ``K4F_SP_CASES``: phase 7d's (2, 1024, 2048) at sp 2 and 4, sp 3, an
   odd d, one element off alignment and a T past shared memory;
6. runs one FabricNet train step (d_model 32, heads 2, two layers, f32) on
   the card and on the CPU from the same numpy weights and compares them;
7. drives the second main path with the launch counts set to zero: 10
   FabricNet train steps at the ``bench_fabricnet`` width (bf16, one
   microbatch) on the one-card mesh, whose loss must stay finite and fall,
   with ms per step, FLOPs per step, TFLOP/s, peak memory and K3 launches
   (one ``attn_fold_fwd_tc``, ``attn_bwd_delta``, ``attn_bwd_dkdv_tc`` and
   ``attn_bwd_dq_tc`` a step, no ``attn_fold_fwd_tf32``,
   ``attn_bwd_dkdv_tf32`` or ``attn_bwd_dq_tf32``, and never the removed
   CUDA-core ``attn_fold_fwd``, ``attn_bwd_dkdv`` or ``attn_bwd_dq``; K4: 6
   ``add_rms_norm_fwd``, 5 ``rms_norm_bwd`` (the first norm reads the
   batch, which takes no gradient), 5 ``gelu_tanh_fwd`` and 5
   ``gelu_tanh_bwd`` a step); then 3 steps of the
   same in f32, counted alike (K3 the other way round); K4e a step
   (``k4e_launches_per_step``): one update, one loss, one combine forward
   and backward;
7b. drives the sliced schedules at the ``bench_fabricnet_overlap`` width
   (two slices, bf16): a warm step each, then 3 interleaved runs of 10
   chained steps from the same parameters; the chained losses (f32) and
   final parameters byte-identical across the schedules and the runs, the
   losses finite and falling, every kernel's launches a step asserted
   (K3 and K4 twice the one-slice counts, the update once, the combine and
   the loss once a slice); ms a step for each, their difference, peak
   memory;
7c. drives the heads = 0 path with the launch counts set to zero: 10 train
   steps at the ``bench_fabricnet`` width with heads = 0 (bf16), the loss
   finite and falling, ms a step on the host clock after 2 warm-up steps,
   peak memory, the launches a step asserted (K4f's forward and backward
   once each, K4a 5, no K3 kernel); device time over two profiled steps,
   and the same with K4f's plain versions, as a record;
7d. drives FabricNet on the fabric mesh, all 8 ranks on the card, at the
   ``bench_fabricnet_overlap`` width in bf16 (``MESH_RUNS``: A {dp2 pp2
   tp2} heads 2, B {pp2 sp2 ep2} heads 2, and heads 0 at lr 1e-3, where
   the reference's step diverges at 1e-2, C {dp2 tp2 sp2} heads 2):
   one fused step with the kernels against the same step with every plain
   version (``mesh_step_check``: the loss within ``MESH_LOSS_RTOL``, the
   gradient of every leaf handed to the update within ``MESH_GRAD_TOL``,
   the update bit for bit the plain update of those gradients, and each
   of ``planted_faults``, a backward kernel's result off by 1%, refused),
   then ``MESH_STEPS`` chained fused steps
   with the launch counts set to zero (the loss finite and falling; every
   kernel's launches a step asserted: the fold ``sp`` times a microbatch and
   stage, K4f once each way a stage with heads 0, K4e-a once a step, the
   loss once a data rank), ms a step on the host clock, peak memory and the
   device time of two profiled steps; on C the forward against the one-rank
   forward of the same parameters and batch (``MESH_FORWARD_TOL``); on B
   serialized against overlapped, byte for byte;
8. times each K3 kernel at the bench attention shape (sp 1 and 4, bf16;
   the tensor-core fold also at B 1, 64 blocks; the f32 fold, dK/dV and dQ
   at sp 1 in f32, their bounds as 3xTF32 work) with CUDA events beside
   its bound, its plain version and ``scaled_dot_product_attention``'s
   forward and backward on the same tensors; times ``attn_bwd_delta`` at
   the bench attention shape in bf16 and f32 behind a spin kernel, both
   forms in turns (general, vector, vector, general), on inputs that arrive
   cold and on one pair again and again, beside its bound, its plain
   version and its wrapper back to back; times K4 at the bench shapes
   in bf16 (K4a also in f32) behind a spin kernel beside its bound, its
   plain version and the nearest PyTorch call (``F.rms_norm``, its autograd
   backward, ``F.gelu(approximate="tanh")`` and ``aten.gelu_backward``,
   which round once where the reference rounds op by op: not the same
   function); times K4e likewise beside ``torch._foreach_add_``
   (for the update; it rounds once, so it is not the same function) and
   ``F.mse_loss`` forward and backward; times K4f's forward and gradient
   at (4, 1024, 2048) bf16 likewise beside their bounds and plain versions
   (no PyTorch call computes either), and its sp form at (2, 1024, 2048)
   sp 2 on inputs in rotation past the L2, beside the sp 1 form on the same
   rotation; and breaks two bf16 train steps,
   then two f32 ones, down by
   kernel with torch.profiler (device busy and idle share; groups K3, K4,
   K4e, cuBLAS, and PyTorch's own elementwise ops and copies);
9. holds K2 (``quantize_rows``, ``dequant_mean_rows``) against its plain
   versions and the numpy twin of ``parallel/quantized.py``, bit for bit,
   in int8 and int4, at ``K2_CASES``: (parties, row bytes) (2, 4096), (3,
   4096), (8, 1 MiB) and (64, 1 MiB) with blocks of 32, (3, 4096) with
   blocks of 4, 8, 16, 64 and 128, (3, 3840) with blocks of 6 and 10, one
   row, rows off 16-byte boundaries, and the shapes of a session across
   processes: (3, 1 MiB), a rank's one 1 MiB row and its 4 chunk views; on
   rows whose first blocks are edge cases (``quant_edge_blocks``), with
   K2b's one-row form (``out_rows=1``) held bitwise in every case; it logs
   the form (vector or general) each kernel ran and holds it to
   ``k2_expected_forms``; and one quantized pmean step of noise rows within
   ``pmean_error_bound``;
10. drives the third main path with the launch counts set to zero:
   ``run_dispatch_session`` at the bench's geometry (2 parties x 4096 B x
   16 steps) and the full one (8 x 1 MiB x 16), modes none, int8 and int4
   under ``chunks=1``, ``chunks=4`` and ``chunks=4, double_buffer=True``
   (byte-identical to ``chunks=1``; quantized within ``pmean_error_bound``
   of the exact session and within 1e-5 of ``np_quantized_pmean``; exact
   bitwise the party-ordered f32 mean), ``_scale_psum_kernel`` sessions
   byte for byte with ``session_expected``, and quantized sessions with
   ``checkpoint_every=4`` resumed from step 8, byte-identical to the
   undisturbed 16 steps; each session's K2 launches must be steps x chunks
   (plus one K2a per checkpoint), 0 for an exact one;
11. times K2 (and K2b's ``mean=False`` form) at (8, 1 MiB) and (64, 1 MiB)
   in int8 and int4 with CUDA events beside its bound, its plain versions
   and the wrapper's time back to back, K2b's one-row form (``out_rows=1``)
   at 3, 8 and 64 parties, and the full-width sessions' ms per
   step in modes none, int8 and int4 with their wire ratios and idle share
   (``--k2-only ROOT`` runs this phase alone on another tree's port);
10b. drives the collective session plane over RPC (``session_plane_phase``),
   with the launch counts set to zero: (a) ``PLANE_PARTIES`` (8) servers on
   cuda:0 with ``enable_collective_service=True``, a pure-scheduler
   proposer calling ``propose_dispatch`` over TCP channels, 8 x 1 MiB x 16
   steps in ``PLANE_RUNS`` (exact, int8, int4, and int8 with ``chunks=4,
   double_buffer=True``): every party's row bitwise phase 10's
   ``run_dispatch_session`` row and its model (the party-ordered f32 mean,
   ``np_quantized_pmean``), K2 launches ``plane_k2_per_session`` (each of
   the 8 handlers computes the whole session, so 8 x steps x chunks); (b)
   ``mc_worker.orchestrate_session`` with 3 processes on cuda:0 over gloo,
   one party a rank, 1 MiB x 16 steps: ``_scale_psum_kernel`` bitwise
   ``session_expected``, then exact, int8 and int4 pmean sessions bitwise
   their models, each process's K2 launches (16 K2a and 16 K2b per
   quantized session) and ms a step, and the client's all_gather time a
   step; the traced int8 session (``--traced-session``: proposed inside a
   handler called with a trace of its own, 4 steps, chunks=2 double-
   buffered), its parties' session, step and chunk spans gathered from the
   3 processes' ``/rpcz`` into one trace tree under the caller's span and
   printed; a server with ``--wrong-kernel`` refused at accept before any
   step; (c) the chaos drill (``PLANE_CHAOS``: party 0 killed at step 3 of
   8, checkpoint every 2, one spare) healed bitwise; the kernels line's K2
   entries carry (a)'s and (b)'s launches as ``plane_launches``;
12. prints the kernels line (JSON), then the result line
   ``{"ok": true, "device": {...}}`` last.

It imports nothing of JAX. It exits non-zero, with no result line, when
PyTorch sees no CUDA card or the port is not beside it.
"""

from __future__ import annotations

import argparse
import gc
import inspect
import json
import math
import os
import re
import subprocess
import sys
import threading
import time
import zlib

import numpy as np

# H100 SXM peaks (NVIDIA data sheet and Hopper white paper, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 33.5e12
F32_FLOPS_PER_S = 67e12  # outside the tensor cores: what K3's f32 FMAs run on
TF32_TC_FLOPS_PER_S = 494.7e12
BF16_TC_FLOPS_PER_S = 989e12

K1 = ("frame_rows", "verify_rows", "echo_step_rows")
K3 = ("attn_fold_fwd_tf32", "attn_fold_fwd_tc", "attn_bwd_delta", "attn_bwd_dkdv_tf32",
      "attn_bwd_dkdv_tc", "attn_bwd_dq_tf32", "attn_bwd_dq_tc")
# the CUDA-core f32 fold, dK/dV and dQ, which attn_fold_fwd_tf32,
# attn_bwd_dkdv_tf32 and attn_bwd_dq_tf32 replaced: they must launch nowhere
REMOVED = ("attn_fold_fwd", "attn_bwd_dkdv", "attn_bwd_dq")
# the fold, dK/dV and dQ kernels each operand dtype launches (ops/attention.py
# fold, dkdv, dq); attn_bwd_delta takes both
FOLD = {"float32": "attn_fold_fwd_tf32", "bfloat16": "attn_fold_fwd_tc"}
DKDV = {"float32": "attn_bwd_dkdv_tf32", "bfloat16": "attn_bwd_dkdv_tc"}
DQ = {"float32": "attn_bwd_dq_tf32", "bfloat16": "attn_bwd_dq_tc"}
K3_BOTH = ("attn_bwd_delta",)
K3_F32 = (FOLD["float32"], DKDV["float32"], DQ["float32"])  # timed, and counted, in f32
K3_SOURCE = {"attn_fold_fwd_tc": "incubator_brpc_tpu_torch/csrc/attention_tc.cu",
             "attn_fold_fwd_tf32": "incubator_brpc_tpu_torch/csrc/attention_tf32.cu",
             "attn_bwd_dkdv_tf32": "incubator_brpc_tpu_torch/csrc/attention_bwd_tf32.cu",
             "attn_bwd_dq_tf32": "incubator_brpc_tpu_torch/csrc/attention_bwd_tf32.cu",
             "attn_bwd_dkdv_tc": "incubator_brpc_tpu_torch/csrc/attention_bwd_tc.cu",
             "attn_bwd_dq_tc": "incubator_brpc_tpu_torch/csrc/attention_bwd_tc.cu"}
# bench.py bench_fabricnet: d_model 2048 over heads 2 -> D 1024, batch 4, seq 1024
BENCH_ATTN = (4, 1024, 2, 1024)
# attn_bwd_delta's timed forms, in turns, and the input bytes its cold calls
# rotate over: three times the 50 MB L2
DELTA_TURNS = ("general", "vector", "vector", "general")
DELTA_ROTATE_BYTES = 150e6
DELTA_VEC = "attn_bwd_delta_vec"  # the vector form's template in ptxas's report
GENERAL = ("general", 32)  # attn_bwd_delta's general form: a warp a row
# attn_bwd_delta's head dimensions beside the K3 cases (phase 5, and the
# card and CPU tests): every lanes-a-row value of the vector form, bf16 rows
# off 16-byte boundaries (D 4, 12, 100) and D past K3's MAX_HEAD_DIM, which
# delta takes; on (3, 37, 3) rows, 333, which fill no form's last block
DELTA_DS = (4, 12, 16, 100, 1000, 1024, 2048, 4096)
DELTA_ROWS = (3, 37, 3)
BENCH_FABRICNET = dict(d_model=2048, d_ff=8192, d_expert=2048, experts_per_rank=2,
                       layers_per_stage=4, batch=4, seq=1024, microbatches=1)

# (rows, payload words): the batches the main path hands the kernels —
# endpoint buckets of 64, 8192, 2^23 (the largest call over RPC) and 2^24
# words and the 2^26-word echo step
GEOMETRIES = [(1, 64), (16, 64), (16, 8192), (1, 1 << 23), (1, 1 << 24), (4, 1 << 24), (1, 1 << 26)]
# the geometry each kernel's line reports: the largest the main path gives it
REPORT_AT = {"frame_rows": (1, 1 << 26), "verify_rows": (1, 1 << 24), "echo_step_rows": (1, 1 << 26)}
K2 = ("quantize_rows", "dequant_mean_rows")
# K2's kernel templates in ptxas's report: each wrapper's vector form, then its general form
K2_KERNELS = ("quantize_vec_kernel", "quantize_kernel", "dequant_vec_kernel", "dequant_kernel")
K2_FORM_KERNELS = {"quantize_rows": K2_KERNELS[:2], "dequant_mean_rows": K2_KERNELS[2:]}
# (parties, row bytes): the bench's 2 x 4096 and 3 x 4096 of the JAX session
# tests, the session plane's MAX_WIDTH (1 MiB, mc_dispatch.py:116) at the 8 data-parallel ranks
# of one DGX H100, and at 64 parties (64 MiB of f32, beyond the 50 MB L2)
K2_GEOMETRIES = [(2, 4096), (3, 4096), (8, 1 << 20), (64, 1 << 20)]
# phase 9's cases, (parties, row bytes, block, layout): the geometries at the
# default block of 32, then the blocks each form takes (4, 8, 16, 64 and 128
# vector; 6 and 10 general, on 3840-byte rows), one row (a checkpoint of one
# party) and rows off 16-byte boundaries (``k2_layout``), which K2a takes in
# its general form
K2_CASES = ([(p, w, 32, "contiguous") for p, w in K2_GEOMETRIES]
            + [(3, 4096, b, "contiguous") for b in (4, 8, 16, 64, 128)]
            + [(3, 3840, 6, "contiguous"), (3, 3840, 10, "contiguous"), (1, 4096, 32, "contiguous"),
               (3, 4096, 32, "offset"), (3, 4096, 32, "stride")]
            # a session across processes: K2b's one-row form on 3 gathered 1 MiB
            # rows, and K2a on a rank's one 1 MiB row and on its 4 chunk views
            + [(3, 1 << 20, 32, "contiguous"), (1, 1 << 20, 32, "contiguous")]
            + [(1, 1 << 18, 32, f"chunk{j}") for j in range(4)])
# (parties, row bytes, steps): bench.py:1184 _mc_quantized_child, and the full width
SESSIONS = {"bench": (2, 4096, 16), "full": (8, 1 << 20, 16)}
SCHEDULES = [(1, False), (4, False), (4, True)]  # (chunks, double_buffer)
REPLACES = {
    "quantize_rows": "incubator_brpc_tpu/parallel/quantized.py:197",
    "dequant_mean_rows": "incubator_brpc_tpu/parallel/quantized.py:220",
    "frame_rows": "incubator_brpc_tpu/ops/framing.py:96",
    "verify_rows": "incubator_brpc_tpu/ops/framing.py:121",
    "echo_step_rows": "incubator_brpc_tpu/models/tensor_echo.py:42",
    "attn_fold_fwd_tf32": "incubator_brpc_tpu/models/ring_attention.py:35",
    "attn_fold_fwd_tc": "incubator_brpc_tpu/models/ring_attention.py:35",
    "attn_bwd_delta": "incubator_brpc_tpu/models/ring_attention.py:48",
    "attn_bwd_dkdv_tf32": "incubator_brpc_tpu/models/ring_attention.py:48",
    "attn_bwd_dkdv_tc": "incubator_brpc_tpu/models/ring_attention.py:48",
    "attn_bwd_dq_tf32": "incubator_brpc_tpu/models/ring_attention.py:48",
    "attn_bwd_dq_tc": "incubator_brpc_tpu/models/ring_attention.py:48",
    "add_rms_norm_fwd": "incubator_brpc_tpu/models/fabricnet.py:119",
    "rms_norm_bwd": "incubator_brpc_tpu/models/fabricnet.py:119",
    "gelu_tanh_fwd": "incubator_brpc_tpu/models/fabricnet.py:123",
    "gelu_tanh_bwd": "incubator_brpc_tpu/models/fabricnet.py:123",
    "sgd_update_multi": "incubator_brpc_tpu/models/fabricnet.py:405",
    "moe_combine_fwd": "incubator_brpc_tpu/models/fabricnet.py:175",
    "moe_combine_bwd": "incubator_brpc_tpu/models/fabricnet.py:175",
    "mse_loss_fwd": "incubator_brpc_tpu/models/fabricnet.py:268",
    "ring_mean_add_fwd": "incubator_brpc_tpu/models/fabricnet.py:138",
    "ring_mean_add_bwd": "incubator_brpc_tpu/models/fabricnet.py:138",
}
KINDS = ("valid", "bad_magic", "bad_length", "flipped_word", "unknown_method")
K4 = ("add_rms_norm_fwd", "rms_norm_bwd", "gelu_tanh_fwd", "gelu_tanh_bwd")
# bench_fabricnet's shapes at one microbatch: the norms' rows (4096 tokens x
# d_model 2048), the MLP's pre-activations (4096 x d_ff 8192) and the MoE's
# (2 experts x 2048 tokens x d_expert 2048)
K4_SHAPES = [(4096, 2048), (4096, 8192), (2, 2048, 2048)]
# odd widths (rows that begin off 16-byte boundaries), contiguous and one
# element into a buffer: (shape, offset)
K4_ODD = [((5, 33), False), ((3, 1000), False), ((4, 33), True), ((4, 1000), True)]
# (dtype, d, one element off 16-byte alignment): the widest rows K4a keeps in
# registers (read once) and the next widths, which it reads twice, with the
# row's pointers on one 16-byte phase (vectors) and not (single elements)
K4A_CAP = [("bfloat16", 16384, False), ("bfloat16", 16392, False), ("bfloat16", 2048, True),
           ("bfloat16", 2052, True), ("float32", 8192, False), ("float32", 8196, False),
           ("float32", 2048, True), ("float32", 2052, True)]
# f32 operations an element (the bound's operations side; tanhf counts as one)
K4_OPS_PER_ELEMENT = {"add_rms_norm_fwd": 4, "rms_norm_bwd": 9, "gelu_tanh_fwd": 9,
                      "gelu_tanh_bwd": 22}
K4E = ("sgd_update_multi", "moe_combine_fwd", "moe_combine_bwd", "mse_loss_fwd")
K4E_SOURCE = {"sgd_update_multi": "incubator_brpc_tpu_torch/csrc/update.cu",
              "moe_combine_fwd": "incubator_brpc_tpu_torch/csrc/elementwise.cu",
              "moe_combine_bwd": "incubator_brpc_tpu_torch/csrc/elementwise.cu",
              "mse_loss_fwd": "incubator_brpc_tpu_torch/csrc/elementwise.cu"}
# K4f, the heads = 0 ring mean (ops/elementwise.py ring_mean_add_fwd / _bwd);
# its kernel is one template, ring_mean_add, in ptxas's report and the profile
K4F = ("ring_mean_add_fwd", "ring_mean_add_bwd")
K4F_KERNEL = "ring_mean_add"
# K4f's (batch, T, d) and whether every input starts one element into its
# buffer: the bench width, a ragged T, an odd d, one element off 16-byte
# alignment, and a T whose 128-byte column tile does not fit in shared
# memory (pass 2 reads the inputs again)
K4F_CASES = [((4, 1024, 2048), False), ((2, 37, 2048), False), ((3, 50, 33), False),
             ((2, 100, 2048), True), ((1, 2048, 256), False)]
# K4f's sp form (the sp ring's mean, heads = 0 on a mesh with sp > 1): (batch,
# T, d), one element off alignment, sp. Phase 7d's stage input on {pp2 sp2
# ep2} (2, 1024, 2048) at sp 2 and 4, sp 3 (the ranks' fold orders differ in
# the last bit), an odd d, one element off alignment, and a T past shared
# memory
K4F_SP_CASES = [((2, 1024, 2048), False, 2), ((2, 1024, 2048), False, 4), ((3, 36, 40), False, 3),
                ((2, 98, 33), False, 2), ((4, 60, 1000), True, 4), ((1, 2400, 72), False, 3)]
K4F_SP_SHAPE, K4F_SP = (2, 1024, 2048), 2
K4F_ROTATE_BYTES = 150e6  # K4f's timed inputs in rotation, past the 50 MB L2
# phase 7d: FabricNet's bf16 train step at the bench_fabricnet_overlap width
# with all 8 ranks of a mesh on the card: (name, axis sizes, heads, lr). The
# config's lr 1e-2, but with heads = 0 on {pp2 sp2 ep2}: there the JAX
# package's own step (8 layers through two ring means) diverges at 1e-2
# (losses 15.8, 34.7, 32.6, 40.4, ... at d_model 256 in f32 on the CPU, the
# port's equal to 4 decimals; 13.9, 26.0, 35.3, ... on the card at full
# width) and falls at 1e-3; at 1e-3 a heads = 2 step's bf16 loss moves less
# than its ulp in 6 steps
MESH_RUNS = [("A", {"dp": 2, "pp": 2, "tp": 2}, 2, 1e-2),
             ("B", {"pp": 2, "sp": 2, "ep": 2}, 2, 1e-2),
             ("B", {"pp": 2, "sp": 2, "ep": 2}, 0, 1e-3),
             ("C", {"dp": 2, "tp": 2, "sp": 2}, 2, 1e-2)]
MESH_STEPS = 6  # chained fused steps a mesh, the first a warm-up for the clock
# the step with the kernels against the same step with the plain versions,
# bf16 from the same parameters: the loss within 2^-6 relative (two bf16
# ulps: K3's tensor-core products and K4a's sum order move the forward by
# about one ulp); each leaf's gradient, the one the update is handed, within
# MESH_GRAD_TOL of the plain one by each of gradient_errors' readings; the
# update bit for bit the plain update of the kernels' gradients; and each of
# planted_faults' 1% faults above MESH_GRAD_TOL in some reading. Measured at
# this width on an H100 (the worst leaf of MESH_RUNS): largest 0.0111, norm
# 0.0094 (rounding in another order, most in the first layer's w_in, which
# every layer's gradient reaches), bias 2.3e-4; at the small width of
# tests/test_torch_cuda.py bias 1.4e-3 (a gate of 64 elements). The 1%
# faults in dQ and K4f's gradient move norm and largest no further than
# rounding does (0.010-0.015) but bias by 0.0089-0.0099; K4b's by 0.05-0.11
MESH_LOSS_RTOL = 2.0 ** -6
MESH_GRAD_TOL = {"largest": 2.0 ** -5, "norm": 2.0 ** -5, "bias": 2.0 ** -8}
# the same check at a small width on {pp2 sp2 ep2} (tests/test_torch_cuda.py's
# mesh step; parameters from seed 21, the batch from 22), heads 2 and 0, bf16
# within the tolerances above and f32 within 1e-5 in every reading (3xTF32
# and the sums' order)
MESH_SMALL = dict(d_model=64, d_ff=128, d_expert=64, layers_per_stage=2, batch=4, seq=64,
                  microbatches=2)
MESH_SMALL_F32_TOL = 1e-5
# C's forward against the one-rank forward of the same parameters and batch
# (bf16; the reference holds f32 to rtol 2e-4, atol 2e-5): within 2^-5 of
# max(1, max |one-rank|), four bf16 ulps of the largest value; the tp
# partial products are rounded to bf16 before their psum and the ring
# merges sp blocks, each a rounding the residual stream carries
MESH_FORWARD_TOL = 2.0 ** -5
# bench.py:926 bench_fabricnet_overlap: bench_fabricnet's width with two slices
BENCH_OVERLAP = dict(BENCH_FABRICNET, microbatches=2)
# K4e-b/c's (t, e, d): the bench's one microbatch (4096 tokens, 2 experts, d_model
# 2048), a sliced step's slice, and odd ones
K4E_MOE_SHAPES = [(4096, 2, 2048), (2048, 2, 2048), (12, 2, 33), (9, 3, 1000)]
# K4e-d's shapes: the bench output, one slice's, and odd ones
K4E_LOSS_SHAPES = [(4, 1024, 2048), (2, 1024, 2048), (5, 33), (3, 1000)]
# K4e-a's mixed table: leaf sizes 1, 2048 (the gate), 2^24 + 3, 33 and 1000, each
# as (elements, offsets of p, g and acc into their buffers in elements): aligned,
# all one element in (a head and a tail), and disagreeing (single elements)
K4E_MIXED = [(1, (0, 0, 0)), (2048, (0, 0, 0)), ((1 << 24) + 3, (1, 1, 1)),
             (33, (1, 0, 1)), (1000, (3, 3, 3)), (2048, (0, 1, 0))]
# p = 1 and lr * g = -(2^-24 + 2^-60) exactly in float32: one rounding gives
# 1 + 2^-23 (tests/test_torch_update.py)
CRAFTED_LR, CRAFTED = 4097 / 4096, (1.0, -16773121 * 2.0 ** -48)


def log(msg: str) -> None:
    print(msg, flush=True)


# -- K2 inputs (phases 9-10; tests/test_torch_cuda.py and
# tests/test_torch_quantized.py use the same rows) ------------------------------

FLT_MAX = float(np.finfo(np.float32).max)
QMAX = {"int8": 127, "int4": 7}


def quant_edge_blocks(block: int, mode: str, seed: int = 0) -> np.ndarray:
    """Eight scale blocks that probe K2's arithmetic, one after another:
    ``[8, block]`` f32. In order: all zero (e = 0, q = 0); amax / qmax
    exactly 2^5 (frexp's mantissa 0.5); x / 2^3 on exact .5 ties of both
    parities; subnormal values (e clamps at -126, q = 0); tiny normals
    whose amax / qmax is subnormal (e = -126, q != 0); positive values up
    to FLT_MAX (the largest exponent finite data reaches, 122 for int8 and
    126 for int4, whose top value dequantizes to +inf); mixed signs up to
    0.9 FLT_MAX; alternating signs at magnitude 100."""
    qmax = QMAX[mode]
    rng = np.random.default_rng(seed)
    rnd = lambda: rng.standard_normal(block)  # noqa: E731
    pow2 = np.clip(rnd(), -0.99, 0.99) * qmax * 32.0
    pow2[3] = qmax * 32.0
    ties = (np.arange(block) % (2 * qmax) - qmax + 0.5) * 8.0
    ties[0] = qmax * 8.0
    huge = rng.uniform(0.5, 1.0, block) * FLT_MAX
    huge[1] = FLT_MAX
    blocks = [
        np.zeros(block), pow2, ties, rnd() * 1e-40, rnd() * 2.0 ** -120, huge,
        np.clip(rnd() / 4, -1, 1) * 0.9 * FLT_MAX,
        rnd() * 100.0 * np.where(np.arange(block) % 2, 1.0, -1.0),
    ]
    return np.stack(blocks).astype(np.float32)


def k2_expected_forms(block: int, mode: str, layout: str) -> dict:
    """The forms ``ops/quantize.py`` picks for a ``k2_case``: K2a's vector
    form wants blocks of 4-128 floats, a power of two, and rows on 16-byte
    boundaries; K2b's wants blocks of a multiple of 4 and q on the boundary
    of a 4-value word (``"offset"`` moves it one byte off)."""
    vec_q = block in (4, 8, 16, 32, 64, 128) and (layout == "contiguous"
                                                  or layout.startswith("chunk"))
    vec_d = block % 4 == 0 and layout != "offset"
    return {"quantize_rows": ["vector" if vec_q else "general"],
            "dequant_mean_rows": ["vector" if vec_d else "general"]}


def quant_rows(parties: int, nfloats: int, block: int, mode: str, seed: int,
               edges: bool = True) -> np.ndarray:
    """``[parties, nfloats]`` f32: party p's row is normal noise at scale 3
    (p + 1), its first blocks the edge blocks rolled by p (``edges``)."""
    rng = np.random.default_rng(seed)
    scale = 3.0 * np.arange(1, parties + 1, dtype=np.float32)[:, None]
    rows = rng.standard_normal((parties, nfloats), dtype=np.float32) * scale
    if edges:
        edge = quant_edge_blocks(block, mode, seed)
        k = min(len(edge), nfloats // block)
        for p in range(parties):
            rows[p, : k * block] = np.roll(edge, p, axis=0)[:k].reshape(-1)
    return rows


def ptxas_report(build_log: str, names) -> dict:
    """Registers and spill bytes of each kernel entry in ptxas's report (one
    entry per template instance), keyed by the longest of ``names`` that the
    mangled entry name holds (K3's entries carry their wrappers' names)."""
    report, cur = {}, None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            held = [n for n in names if n in m.group(1)]
            cur = {"entry": m.group(1)} if held else None
            if cur:
                report.setdefault(max(held, key=len), []).append(cur)
        elif cur is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                cur["registers"] = int(m.group(1))
    return report


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


SPIN_TRIES = 3  # runs device_ms makes, each behind a longer spin, before it gives up


def device_ms(torch, fn, iters: int, warmup: int = 2):
    """Mean device time of ``fn`` over ``iters`` calls queued behind a spin
    kernel, so the host's cost of each call is off the clock: (ms, whether
    the host finished queueing before the spin ended). The spin lasts four
    times the host's time for ``iters`` calls; where the host was not done
    when it ended (a host shared with other work can stall), the run is
    made again behind a spin four times as long, up to ``SPIN_TRIES`` runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    spin_s = max(4 * iters * (time.perf_counter() - t0), 2e-3)
    for _ in range(SPIN_TRIES):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        spin_end = torch.cuda.Event()
        torch.cuda._sleep(int(spin_s * 2e9))  # cycles at up to 2 GHz
        spin_end.record()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        queued_in_time = not spin_end.query()
        end.synchronize()
        if queued_in_time:
            break
        spin_s *= 4
    return start.elapsed_time(end) / iters, queued_in_time


def bound_ms(nbytes: int, ops: int):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Phase2:
    """Kernel vs plain version on the card, bitwise, with timings."""

    def __init__(self, torch, kernels, dev):
        self.torch, self.k, self.dev = torch, kernels, dev
        self.gen = torch.Generator(device=dev)
        self.gen.manual_seed(20261017)
        self.max_err = dict.fromkeys(K1, 0)
        self.timings = {}

    def words(self, shape):
        t = self.torch.randint(0, 1 << 32, shape, dtype=self.torch.int64,
                               generator=self.gen, device=self.dev)
        return self.k.bits32(t).view(self.torch.uint32)

    def check(self, name, got, want):
        k, torch = self.k, self.torch
        if got.dtype == torch.bool:
            same = torch.equal(got, want)
            err = int((got != want).sum())
        else:
            same = torch.equal(got.view(torch.int32), want.view(torch.int32))
            err = 0 if same else int((k.u64(got) - k.u64(want)).abs().max())
        self.max_err[name] = max(self.max_err[name], err)
        if not same:
            raise AssertionError(f"{name}: kernel and plain version differ (max abs err {err})")

    def requests(self, rows, words, offset):
        torch, k = self.torch, self.k
        payload = self.words((rows, words))
        cid_lo, cid_hi = self.words((rows,)), self.words((rows,))
        mid = torch.zeros(rows, dtype=torch.int32, device=self.dev).view(torch.uint32)
        framed = k.frame_rows_plain(payload, cid_lo, mid, cid_hi=cid_hi)
        v = framed.view(torch.int32)
        kinds = [KINDS[(r + offset) % len(KINDS)] for r in range(rows)]
        for r, kind in enumerate(kinds):
            if kind == "bad_magic":
                v[r, 0] = 0x50525043
            elif kind == "bad_length":
                v[r, 1] = words + 1
            elif kind == "flipped_word":
                v[r, 8 + words // 2] = v[r, 8 + words // 2] ^ 1
            elif kind == "unknown_method":
                v[r, 5] = 999
        return framed, kinds

    def run(self, rows, words):
        torch, k = self.torch, self.k
        big = rows * words >= 1 << 22
        iters, plain_iters = (20, 5) if big else (200, 50)
        payload = self.words((rows, words))
        cid_lo, cid_hi, mid, err = (self.words((rows,)) for _ in range(4))
        args = (payload, cid_lo, mid)
        kw = dict(cid_hi=cid_hi, err=err, flags=2)
        self.check("frame_rows", k.frame_rows(*args, **kw), k.frame_rows_plain(*args, **kw))
        for offset in (0, 3):  # a B=1 geometry sees a valid and a corrupt row
            framed, kinds = self.requests(rows, words, offset)
            ok = k.verify_rows(framed)
            self.check("verify_rows", ok, k.verify_rows_plain(framed))
            want_ok = [kind in ("valid", "unknown_method") for kind in kinds]
            if ok.tolist() != want_ok:
                raise AssertionError(f"verify_rows: {ok.tolist()} for {kinds}")
            resp = k.echo_step_rows(framed)
            self.check("echo_step_rows", resp, k.echo_step_rows_plain(framed))
            codes = k.u64(resp[:, 7]).tolist()
            want = [{"valid": 0, "unknown_method": 1002}.get(kind, 1003) for kind in kinds]
            if codes != want:
                raise AssertionError(f"echo_step_rows: codes {codes} for {kinds}")
        # timed on valid requests, what the main path carries; a failed
        # row costs K1c one more write of its payload (the zero fill)
        mid0 = torch.zeros(rows, dtype=torch.int32, device=self.dev).view(torch.uint32)
        valid = k.frame_rows_plain(payload, cid_lo, mid0, cid_hi=cid_hi)
        torch.cuda.synchronize()
        frame_out = torch.empty((rows, words + 8), dtype=torch.int32, device=self.dev)
        valid_i32 = valid.view(torch.int32)
        copy_out = torch.empty_like(valid_i32)
        payload_i32 = payload.view(torch.int32)
        wb = 4 * rows * (words + 8)
        cases = {
            "frame_rows": (lambda: k.frame_rows(*args, **kw), lambda: k.frame_rows_plain(*args, **kw),
                           lambda: frame_out[:, 8:].copy_(payload_i32),
                           4 * rows * words + 16 * rows + wb),
            "verify_rows": (lambda: k.verify_rows(valid), lambda: k.verify_rows_plain(valid),
                            lambda: copy_out.copy_(valid_i32), wb + rows),
            "echo_step_rows": (lambda: k.echo_step_rows(valid), lambda: k.echo_step_rows_plain(valid),
                               lambda: copy_out.copy_(valid_i32), 2 * wb),
        }
        parts = []
        for name, (kern, plain, copy, nbytes) in cases.items():
            b, by = bound_ms(nbytes, rows * words)
            ms, queued = device_ms(torch, kern, iters)
            t = {
                "ms": ms, "queued_in_time": queued,
                # back to back through the wrapper: the rate the RPC path sees
                "host_ms": time_ms(torch, kern, iters),
                "plain_ms": device_ms(torch, plain, plain_iters)[0],
                "copy_ms": device_ms(torch, copy, iters)[0],
                "bound_ms": b, "bound_by": by, "bytes": nbytes,
            }
            if name == "echo_step_rows":
                t["corrupt_batch_ms"] = device_ms(torch, lambda: k.echo_step_rows(framed), iters)[0]
            self.timings[(name, rows, words)] = t
            parts.append(f"{name} {t['ms']}ms ({100 * b / ms:.1f} % of bound {b}"
                         + ("" if queued else ", host-bound") + f"; back to back {t['host_ms']}; "
                         f"plain {t['plain_ms']}, copy_ {t['copy_ms']})")
        log(f"phase2 B={rows} W={words}: bitwise equal; device time behind a spin kernel: "
            + "; ".join(parts)
            + f"; echo_step_rows with {sum(x != 'valid' for x in kinds)} of {rows} rows failing: "
            f"{self.timings[('echo_step_rows', rows, words)]['corrupt_batch_ms']}ms")


def call_threads(n_threads, fn):
    errors = []

    def run(i):
        try:
            fn(i)
        except BaseException as e:  # noqa: BLE001 — re-raised in the main thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
        if t.is_alive():
            raise AssertionError("a caller thread did not finish")
    if errors:
        raise errors[0]


def expected(words: np.ndarray, mid: int) -> np.ndarray:
    w = words.astype(np.uint64)
    if mid == 3:
        w = w * 2
    elif mid == 5:
        w = w + 10
    return (w & 0xFFFFFFFF).astype(np.uint32)


def run_calls(ep, n_threads, per_thread, nbytes, mid_of, rng_seed):
    """n_threads x per_thread call_bytes calls; checks every answer.
    Returns (qps, mean latency in µs)."""
    from incubator_brpc_tpu_torch.utils.status import ErrorCode

    rng = np.random.default_rng(rng_seed)
    payloads = [[rng.integers(0, 256, size=nbytes, dtype=np.uint8).tobytes()
                 for _ in range(per_thread)] for _ in range(n_threads)]
    lat = []
    lock = threading.Lock()

    def caller(i):
        for j in range(per_thread):
            mid = mid_of(i, j)
            t0 = time.perf_counter()
            code, out = ep.call_bytes(payloads[i][j], method_id=mid,
                                      correlation_id=i * 1000 + j + 1, timeout=300)
            dt = time.perf_counter() - t0
            if mid == 999:
                if code != ErrorCode.ENOMETHOD:
                    raise AssertionError(f"method 999 gave code {code}")
            else:
                if code != 0:
                    raise AssertionError(f"call ({i},{j}) method {mid} gave code {code}")
                words = np.frombuffer(payloads[i][j] + b"\0" * (-nbytes % 4), np.uint32)
                if out != expected(words, mid).tobytes()[:nbytes]:
                    raise AssertionError(f"call ({i},{j}) method {mid}: wrong response")
            with lock:
                lat.append(dt)

    t0 = time.perf_counter()
    call_threads(n_threads, caller)
    wall = time.perf_counter() - t0
    return len(lat) / wall, 1e6 * sum(lat) / len(lat)


# -- phase 3b: device RPC through the port's Server and Channel -----------------

RPC_METHODS = {0: "echo", 3: "x2", 5: "plus10", 999: "unknown"}
RPC_BIG_WORDS = 1 << 23  # the largest bucket whose frame fits max_body_size (64 MiB)


def rpc_calls(ch, service, n_threads, per_thread, nbytes, mid_of, rng_seed):
    """n_threads x per_thread Channel calls of ``service``; checks every
    answer and error code. Returns (calls/s, mean latency in µs)."""
    from incubator_brpc_tpu_torch.utils.status import ErrorCode

    rng = np.random.default_rng(rng_seed)
    payloads = [[rng.integers(0, 256, size=nbytes, dtype=np.uint8).tobytes()
                 for _ in range(per_thread)] for _ in range(n_threads)]
    lat = []
    lock = threading.Lock()

    def caller(i):
        for j in range(per_thread):
            mid = mid_of(i, j)
            t0 = time.perf_counter()
            cntl = ch.call_method(service, RPC_METHODS[mid], payloads[i][j])
            dt = time.perf_counter() - t0
            if mid == 999:
                if cntl.error_code != ErrorCode.ENOMETHOD or cntl.response_payload != b"":
                    raise AssertionError(f"rpc method 999 gave code {cntl.error_code}")
            else:
                if not cntl.ok():
                    raise AssertionError(f"rpc ({i},{j}) {service}.{RPC_METHODS[mid]} gave "
                                         f"code {cntl.error_code}: {cntl.error_text}")
                words = np.frombuffer(payloads[i][j] + b"\0" * (-nbytes % 4), np.uint32)
                if cntl.response_payload != expected(words, mid).tobytes()[:nbytes]:
                    raise AssertionError(f"rpc ({i},{j}) {service}.{RPC_METHODS[mid]}: wrong response")
            with lock:
                lat.append(dt)

    t0 = time.perf_counter()
    call_threads(n_threads, caller)
    wall = time.perf_counter() - t0
    return len(lat) / wall, 1e6 * sum(lat) / len(lat)


def rpc_calls_host(ch, n_threads, per_thread):
    """n_threads x per_thread calls of the host-only echo (256 B); returns
    (calls/s, mean latency in µs)."""
    payload = bytes(range(256))
    lat = []
    lock = threading.Lock()

    def caller(i):
        for _ in range(per_thread):
            t0 = time.perf_counter()
            cntl = ch.call_method("host", "echo", payload)
            dt = time.perf_counter() - t0
            if not cntl.ok() or cntl.response_payload != payload:
                raise AssertionError(f"host echo: code {cntl.error_code}")
            with lock:
                lat.append(dt)

    t0 = time.perf_counter()
    call_threads(n_threads, caller)
    wall = time.perf_counter() - t0
    return len(lat) / wall, 1e6 * sum(lat) / len(lat)


def sequential_us(call, n=20):
    """Mean µs of ``n`` calls made one after another (each checks itself)."""
    t0 = time.perf_counter()
    for _ in range(n):
        call()
    return 1e6 * (time.perf_counter() - t0) / n


def device_busy(prof) -> tuple:
    """(device busy µs, [(kernel, count, µs)] largest first) of a
    torch.profiler run; busy is 0 where the profiler saw no device time."""
    kern = [e for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")]
    dev_us = lambda e: getattr(e, "self_device_time_total", None) or getattr(  # noqa: E731
        e, "self_cuda_time_total", 0)
    by_name = sorted(((e.key[:70], e.count, dev_us(e)) for e in kern), key=lambda x: -x[2])
    return sum(t for _, _, t in by_name), by_name


def profile_rpc_burst(torch, ch, label="phase3b"):
    """torch.profiler (device activity) over a pipelined 16 x 8 burst of
    256 B calls: wall time, device busy time and the idle share."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rpc_calls(ch, "tensor", 16, 8, 256, lambda i, j: 0, 11)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy, by_name = device_busy(prof)
    if not busy:
        log(f"{label} profile of the RPC burst: the profiler saw no device time (not measured)")
        return {"wall_us": wall_us, "device_us": None, "idle_pct": None}
    idle = 100.0 - 100.0 * busy / wall_us
    log(f"{label} profile of the pipelined 16 x 8 RPC burst (256 B): wall {wall_us:.1f} us, "
        f"device busy {busy:.1f} us, idle {idle:.2f} %; "
        + "; ".join(f"{k} x{c} {t:.1f} us" for k, c, t in by_name[:6]))
    return {"wall_us": wall_us, "device_us": busy, "idle_pct": idle}


def body_crc_cost_us(n=20):
    """Host µs to pack one tbus_std frame of a 32 KiB body, the meta alone
    checksummed (the default) and with the body-checksum bit set."""
    from incubator_brpc_tpu_torch.protocol import tbus_std

    body = bytes(range(256)) * 128
    meta = tbus_std.Meta(service="tensor", method="echo", timeout_ms=300000)
    out = {}
    for label, flags in (("meta_crc_us", 0), ("body_crc_us", tbus_std.FLAG_BODY_CRC)):
        out[label] = sequential_us(lambda: tbus_std.pack_frame(meta, body, 7, flags=flags), n)
    return out


def device_rpc_phase(torch, kernels, svc, direct_seq_us):
    """Phase 3b: DeviceEndpoint.server_handler() mounted on the port's
    Server, called through the port's Channel on loopback at
    bench_device_rpc's geometry (bench.py:684-753): window 16, 256 B
    payloads after a warm-up, 20 sequential calls, 16 threads x 8 calls,
    the mixed table {0, 3, 5, 999} through a second service, a burst of 16
    calls of 32 KiB and one call of 2^23 words; every answer and code
    checked. The caller resets and reads the launch counts around it."""
    from incubator_brpc_tpu_torch.rpc import Channel, ChannelOptions, Server
    from incubator_brpc_tpu_torch.transport.device import DeviceEndpoint

    echo_ep = DeviceEndpoint(window_size=16, max_batch=16)
    mixed_ep = DeviceEndpoint(service=svc, window_size=16, max_batch=16)
    handler_s = []  # seconds inside the echo handler, call by call

    def timed(handler):
        def run(cntl, request):
            t0 = time.perf_counter()
            try:
                return handler(cntl, request)
            finally:
                handler_s.append(time.perf_counter() - t0)
        return run

    server = Server()
    server.add_service("tensor", {"echo": timed(echo_ep.server_handler())})
    server.add_service("mixed", {name: mixed_ep.server_handler(method_id=mid)
                                 for mid, name in RPC_METHODS.items()})
    # the host plane alone: the same Server and Channel, no device
    server.add_service("host", {"echo": lambda cntl, request: request})
    if not server.start(0):
        raise AssertionError("the port's Server did not start")
    out = {}
    try:
        ch = Channel()
        ch.init(f"127.0.0.1:{server.port}", options=ChannelOptions(timeout_ms=300_000))
        echo_ep.warm(256)
        mixed_ep.warm(256)
        rpc_calls(ch, "tensor", 16, 2, 256, lambda i, j: 0, 20)  # warm-up
        rng = np.random.default_rng(21)
        seq_payloads = [rng.integers(0, 256, size=256, dtype=np.uint8).tobytes() for _ in range(20)]
        it = iter(seq_payloads)

        def one():
            p = next(it)
            cntl = ch.call_method("tensor", "echo", p)
            if not cntl.ok() or cntl.response_payload != p:
                raise AssertionError(f"sequential rpc: code {cntl.error_code}")

        del handler_s[:]
        out["rpc_seq_us"] = sequential_us(one, 20)
        out["handler_seq_us"] = 1e6 * sum(handler_s) / len(handler_s)
        out["host_plane_us"] = out["rpc_seq_us"] - direct_seq_us
        host_payload = bytes(range(256))

        def host_one():
            cntl = ch.call_method("host", "echo", host_payload)
            if not cntl.ok() or cntl.response_payload != host_payload:
                raise AssertionError(f"host echo: code {cntl.error_code}")

        sequential_us(host_one, 20)  # warm-up
        out["host_echo_seq_us"] = sequential_us(host_one, 200)
        del handler_s[:]
        out["rpc_qps"], out["rpc_lat_us"] = rpc_calls(ch, "tensor", 16, 8, 256, lambda i, j: 0, 22)
        out["handler_burst_us"] = 1e6 * sum(handler_s) / len(handler_s)
        out["host_echo_qps"], _ = rpc_calls_host(ch, 16, 8)
        log(f"phase3b device RPC through the port's Server and Channel, 256 B: sequential "
            f"{out['rpc_seq_us']:.1f} us a call (the endpoint alone {direct_seq_us:.1f} us: the host "
            f"plane adds {out['host_plane_us']:.1f} us; inside the server's handler "
            f"{out['handler_seq_us']:.1f} us; a host-only echo over the same Server and Channel "
            f"{out['host_echo_seq_us']:.1f} us); 16 threads x 8 calls: {out['rpc_qps']:.1f} calls/s, "
            f"mean latency {out['rpc_lat_us']:.1f} us, {out['handler_burst_us']:.1f} us a call inside "
            f"the handler (the host-only echo {out['host_echo_qps']:.1f} calls/s)")
        qps, lat = rpc_calls(ch, "mixed", 16, 8, 256,
                             lambda i, j: 999 if (i, j) == (5, 3) else (0, 3, 5)[(i + j) % 3], 23)
        out["rpc_mixed_qps"] = qps
        log(f"phase3b mixed service {{0,3,5,999}} over RPC, 16 threads x 8 calls of 256 B: "
            f"{qps:.1f} calls/s, mean latency {lat:.1f} us; method 999 failed with ENOMETHOD")
        mixed_ep.warm(32 * 1024)
        qps, lat = rpc_calls(ch, "mixed", 16, 1, 32 * 1024, lambda i, j: (0, 3, 5)[i % 3], 24)
        out["rpc_burst_32k_qps"] = qps
        log(f"phase3b burst of 16 RPC calls of 32 KiB: {qps:.1f} calls/s, mean latency {lat:.1f} us")
        _, lat = rpc_calls(ch, "mixed", 1, 1, 4 * RPC_BIG_WORDS, lambda i, j: 3, 25)
        out["rpc_big_us"] = lat
        log(f"phase3b one RPC call of {RPC_BIG_WORDS} words (32 MiB, method 3): latency {lat:.1f} us")
        out["profile"] = profile_rpc_burst(torch, ch)
    finally:
        server.stop()
        server.join(timeout=60)
        for ep in (echo_ep, mixed_ep):
            if not ep.close(timeout=120):
                raise AssertionError("an endpoint did not settle its calls")
    out.update(body_crc_cost_us())
    log(f"phase3b tbus_std pack of a 32 KiB body on the host: meta checksummed "
        f"{out['meta_crc_us']:.1f} us, with the body-checksum bit {out['body_crc_us']:.1f} us "
        "(the host runtime's CRC32C; phase 3f times the plain one)")
    return out


# -- phase 3c: the two-party device link (transport="tpu") ----------------------

# bench.py:807 bench_device_link's stream geometry: 1 MiB slots, window 8,
# 256 MiB in 1 MiB sends; the reference alternates 12 pairs of runs, 3 fit
# this script's time limit
LINK_SLOT_WORDS = 256 * 1024
LINK_WINDOW = 8
LINK_CHUNK = 1 << 20
LINK_TOTAL = 256 << 20
LINK_PAIRS = 3
# (form, host_loopback): the default host swap and the forced device form
LINK_FORMS = (("host swap", None), ("device", False))
LINK_BIG_WORDS = 1 << 20  # one device RPC of 4 MiB: 64 of the default 64 KiB slots
# the quantized pmean device method served over the link
QUANT_WIDTH, QUANT_BLOCK, QUANT_MODE, QUANT_CALLS = 4096, 32, "int8", 8


class StreamSink:
    """Messenger stand-in at the end of a link stream: counts the bytes
    delivered and, when ``hashed``, keeps a running CRC-32 of them."""

    def __init__(self, hashed: bool = False):
        self.nbytes = 0
        self.crc = 0 if hashed else None

    def process(self, sock):
        buf = sock._read_buf
        n = len(buf)
        if self.crc is not None:
            for view in buf.views():
                self.crc = zlib.crc32(view, self.crc)
        buf.popn(n)
        self.nbytes += n


def stream_chunks(size: int = LINK_CHUNK, distinct: int = 8, seed: int = 29):
    """The sends of a link stream: ``distinct`` random chunks in turn."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size, dtype=np.uint8).tobytes() for _ in range(distinct)]


def stream_crc(chunks, total: int) -> int:
    """CRC-32 of the stream ``link_stream`` sends."""
    crc = 0
    for i in range(total // len(chunks[0])):
        crc = zlib.crc32(chunks[i % len(chunks)], crc)
    return crc


def link_stream(dl, dev, host_loopback, ack_mode, chunks, total,
                hashed=False, slot_words=LINK_SLOT_WORDS, window=LINK_WINDOW):
    """``total`` bytes sent in turns of ``chunks`` through a fresh
    ``DeviceLink([dev, dev])`` into a ``StreamSink``, timed from the first
    send to the last byte delivered. Returns (GB/s, sink, link); the link is
    failed afterwards."""
    link = dl.DeviceLink([dev, dev], slot_words=slot_words, window=window,
                         host_loopback=host_loopback, ack_mode=ack_mode)
    dl.DeviceSocket(link, side=0, messenger=StreamSink())
    sink = StreamSink(hashed)
    dl.DeviceSocket(link, side=1, messenger=sink)
    t0 = time.perf_counter()
    for i in range(total // len(chunks[0])):
        rc = link.send(0, chunks[i % len(chunks)], timeout=60)
        if rc != 0:
            raise AssertionError(f"link send: rc {rc}")
    deadline = time.monotonic() + 120
    while sink.nbytes < total and time.monotonic() < deadline:
        time.sleep(0.0005)
    if sink.nbytes != total:
        raise AssertionError(f"link stream delivered {sink.nbytes} of {total} bytes")
    rate = total / (time.perf_counter() - t0) / 1e9
    link.fail("stream done")
    return rate, sink, link


def link_echo(ch_tpu, ch_tcp):
    """Phase 3c (a): 1 KiB echo over the link (a warm call, then 200 in a
    row), beside the same 200 calls over TCP; the link is built once and
    stays the same object."""
    payload = bytes(range(256)) * 4

    def calls(ch, n):
        t0 = time.perf_counter()
        for _ in range(n):
            cntl = ch.call_method("echo", "echo", payload)
            if not cntl.ok() or cntl.response_payload != payload:
                raise AssertionError(f"link echo: code {cntl.error_code} {cntl.error_text}")
        return 1e6 * (time.perf_counter() - t0) / n

    calls(ch_tpu, 1)
    ds = ch_tpu._device_sock
    if ds is None or ds.link is None:
        raise AssertionError("the handshake built no link")
    link = ds.link
    out = {"link_echo_us": calls(ch_tpu, 200)}
    if ch_tpu._device_sock is not ds or ds.link is not link:
        raise AssertionError("the channel's link changed across calls")
    calls(ch_tcp, 1)
    out["tcp_echo_us"] = calls(ch_tcp, 200)
    out["link_form"] = "host swap" if link._step is None else "device"
    out["link_devices"] = [str(d) for d in link.devices]
    return out


def link_device_method_expected(request: bytes) -> bytes:
    """What the quantized pmean device method answers at one party: the
    numpy twin's one-step pmean of the request's floats."""
    from incubator_brpc_tpu_torch.parallel import quantized as Q

    row = np.frombuffer(request, dtype=np.float32)
    return Q.np_quantized_pmean([row], 1, QUANT_MODE, QUANT_BLOCK).tobytes()


def device_link_phase(torch, kernels, svc):
    """Phase 3c: transport="tpu" on the card, through the port only — (a)
    the echo over the link beside TCP, (b) device RPC over the link, (c)
    the quantized pmean device method over the link, (e) teardown and
    re-handshake, (d) the link stream in both forms and both ack modes.
    Returns (detail, the launch counts of (b), those of (c))."""
    from incubator_brpc_tpu_torch.parallel import quantized as Q
    from incubator_brpc_tpu_torch.rpc import (
        Channel, ChannelOptions, Server, ServerOptions, device_method, shutdown_host_plane,
    )
    from incubator_brpc_tpu_torch.transport import device_link as dl
    from incubator_brpc_tpu_torch.transport.device import DeviceEndpoint
    from incubator_brpc_tpu_torch.transport.sock import CONNECTED

    def channel(port, transport):
        ch = Channel()
        ch.init(f"127.0.0.1:{port}", options=ChannelOptions(transport=transport, timeout_ms=120_000))
        return ch

    out = {}
    echo_server = Server(ServerOptions(usercode_inline=True))
    echo_server.add_service("echo", {"echo": lambda cntl, request: request})
    echo_ep = DeviceEndpoint(window_size=16, max_batch=16)
    mixed_ep = DeviceEndpoint(service=svc, window_size=16, max_batch=16)
    quant = Q.quantized_pmean_dm(QUANT_WIDTH, QUANT_MODE, QUANT_BLOCK)
    # blocking handlers: usercode_inline stays False
    dev_server = Server(ServerOptions())
    dev_server.add_service("tensor", {"echo": echo_ep.server_handler()})
    dev_server.add_service("mixed", {name: mixed_ep.server_handler(method_id=mid)
                                     for mid, name in RPC_METHODS.items()})
    dev_server.add_service("quant", {"pmean": device_method(quant.kernel, width=QUANT_WIDTH,
                                                            chunkable=True)})
    servers = [echo_server, dev_server]
    if not (echo_server.start(0) and dev_server.start(0)):
        raise AssertionError("the port's Servers did not start")
    try:
        # (a) the echo over the link, beside TCP
        ch = channel(echo_server.port, "tpu")
        out.update(link_echo(ch, channel(echo_server.port, "tcp")))
        log(f"phase3c echo over the link (transport=tpu, {out['link_form']}, devices "
            f"{out['link_devices']}), 1 KiB, 200 sequential calls: {out['link_echo_us']:.1f} us a "
            f"call; the same calls over TCP on the same server {out['tcp_echo_us']:.1f} us a call; "
            "one link, the same object across calls")

        # (b) device RPC over the link, K1 counted
        dch = channel(dev_server.port, "tpu")
        echo_ep.warm(256)
        mixed_ep.warm(256)
        rpc_calls(dch, "tensor", 16, 1, 256, lambda i, j: 0, 30)  # warm-up (the handshake)
        rpc_calls(dch, "mixed", 16, 1, 256, lambda i, j: 0, 30)
        kernels.reset_launch_counts()
        it = iter([np.random.default_rng(31).integers(0, 256, 256, dtype=np.uint8).tobytes()
                   for _ in range(20)])

        def one():
            p = next(it)
            cntl = dch.call_method("tensor", "echo", p)
            if not cntl.ok() or cntl.response_payload != p:
                raise AssertionError(f"device rpc over the link: code {cntl.error_code}")

        out["link_rpc_seq_us"] = sequential_us(one, 20)
        out["link_rpc_qps"], out["link_rpc_lat_us"] = rpc_calls(
            dch, "mixed", 16, 8, 256,
            lambda i, j: 999 if (i, j) == (5, 3) else (0, 3, 5)[(i + j) % 3], 32)
        mixed_ep.warm(4 * LINK_BIG_WORDS)
        _, out["link_rpc_big_us"] = rpc_calls(dch, "mixed", 1, 1, 4 * LINK_BIG_WORDS,
                                             lambda i, j: 3, 33)
        k1 = kernels.launch_counts()
        missing = [name for name in K1 if k1[name] == 0]
        if missing:
            raise AssertionError(f"kernels not launched on device RPC over the link: {missing}")
        if dch._device_sock is None:
            raise AssertionError("device RPC did not ride a link")
        log(f"phase3c device RPC over the link, 256 B: 20 sequential calls (echo table) "
            f"{out['link_rpc_seq_us']:.1f} us a call; {{0,3,5,999}} 16 threads x 8 calls "
            f"{out['link_rpc_qps']:.1f} calls/s, mean latency {out['link_rpc_lat_us']:.1f} us; one "
            f"call of {LINK_BIG_WORDS} words (4 MiB, 64 slots) {out['link_rpc_big_us']:.1f} us; "
            f"every answer bitwise expected(); launches {[k1[n] for n in K1]} ({', '.join(K1)})")

        # (c) the quantized pmean device method over the link, K2 counted
        rng = np.random.default_rng(34)
        requests = [(rng.standard_normal(QUANT_WIDTH // 4) * 10 ** rng.uniform(-3, 3))
                    .astype(np.float32).tobytes() for _ in range(QUANT_CALLS)]
        cntl = dch.call_method("quant", "pmean", requests[0])  # warm-up, off the count
        if not cntl.ok():
            raise AssertionError(f"device method: code {cntl.error_code} {cntl.error_text}")
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        for req in requests:
            cntl = dch.call_method("quant", "pmean", req)
            if not cntl.ok() or cntl.response_payload != link_device_method_expected(req):
                raise AssertionError(f"device method over the link: code {cntl.error_code}, "
                                     "response not the numpy twin's")
        out["link_quant_us"] = 1e6 * (time.perf_counter() - t0) / QUANT_CALLS
        k2 = kernels.launch_counts()
        if [k2[n] for n in K2] != [QUANT_CALLS] * len(K2):
            raise AssertionError(f"device method: K2 launches {[k2[n] for n in K2]}, "
                                 f"want {QUANT_CALLS} each")
        log(f"phase3c device_method(quantized pmean {QUANT_MODE}, width {QUANT_WIDTH}, block "
            f"{QUANT_BLOCK}) over the link: {QUANT_CALLS} calls bitwise np_quantized_pmean at one "
            f"party, {out['link_quant_us']:.1f} us a call; K2 launches "
            f"{[k2[n] for n in K2]} ({', '.join(K2)}: one each a call)")

        # (e) teardown: server.stop() fails the client's link; the next call
        # re-handshakes a fresh link with the server started again on its port
        ds, port = ch._device_sock, echo_server.port
        echo_server.stop()
        echo_server.join(timeout=60)
        t0 = time.monotonic()
        while ds.state == CONNECTED and time.monotonic() - t0 < 10:
            time.sleep(0.005)
        if ds.state == CONNECTED:
            raise AssertionError("server.stop() did not fail the client's link")
        out["teardown_ms"] = 1e3 * (time.monotonic() - t0)
        again = Server(ServerOptions(usercode_inline=True))
        again.add_service("echo", {"echo": lambda cntl, request: request})
        if not again.start(port):
            raise AssertionError(f"the echo server did not start again on port {port}")
        servers.append(again)
        cntl = ch.call_method("echo", "echo", b"after the teardown")
        if not cntl.ok() or cntl.response_payload != b"after the teardown":
            raise AssertionError(f"call after the teardown: code {cntl.error_code} {cntl.error_text}")
        if ch._device_sock is ds or ch._device_sock.link is ds.link:
            raise AssertionError("the call after the teardown did not re-handshake a fresh link")
        log(f"phase3c teardown: server.stop() failed the client's link in {out['teardown_ms']:.1f} ms; "
            "the next call (the server started again on its port) re-handshook a fresh link")
    finally:
        for server in servers:
            server.stop()
            server.join(timeout=60)
        for ep in (echo_ep, mixed_ep):
            if not ep.close(timeout=120):
                raise AssertionError("an endpoint did not settle its calls")
        shutdown_host_plane()

    # (d) the link stream: both forms, both ack modes, each checked once
    dev = torch.device("cuda", 0)
    chunks = stream_chunks()
    sent_crc = stream_crc(chunks, LINK_TOTAL)
    configs = [(form, lb, mode) for form, lb in LINK_FORMS for mode in ("local", "wire")]
    flips = []
    orig_flip = torch.flip

    def flip_spy(t, dims):
        flips.append(t.device.type)
        return orig_flip(t, dims)

    checked = {}
    for form, lb, mode in configs:  # warm and checked: the delivered bytes' CRC
        torch.flip = flip_spy
        try:
            _, sink, link = link_stream(dl, dev, lb, mode, chunks, LINK_TOTAL, hashed=True)
        finally:
            torch.flip = orig_flip
        if sink.crc != sent_crc:
            raise AssertionError(f"link stream {form}/{mode}: delivered CRC {sink.crc:#x}, "
                                 f"sent {sent_crc:#x}")
        if lb is False and (link._step is None or set(flips) != {"cuda"}
                            or len(flips) < LINK_TOTAL // (4 * LINK_SLOT_WORDS)):
            raise AssertionError(f"the forced device form swapped {len(flips)} slot tensors on "
                                 f"{set(flips)}, want every step on cuda")
        if lb is None and (link._step is not None or flips):
            raise AssertionError("the host swap went through the device")
        checked[f"{form}/{mode}"] = f"{sink.crc:#010x}"
        del flips[:]
    rates = {f"{form}/{mode}": [] for form, _, mode in configs}
    for rep in range(LINK_PAIRS):
        for form, lb, mode in (configs if rep % 2 == 0 else configs[::-1]):
            gc.collect()
            rates[f"{form}/{mode}"].append(link_stream(dl, dev, lb, mode, chunks, LINK_TOTAL)[0])
    out["link_stream_gbps"] = rates
    out["link_stream_crc"] = checked
    log("phase3c link stream, DeviceLink([cuda:0, cuda:0]) slot_words 256 Ki (1 MiB), window 8, "
        f"256 MiB in 1 MiB sends, {LINK_PAIRS} runs each in alternating order, GB/s: "
        + "; ".join(f"{k} {v}" for k, v in rates.items())
        + f"; every form delivered the sent bytes (CRC-32 {sent_crc:#010x})")

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        link_stream(dl, dev, False, "local", chunks, LINK_TOTAL)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy, by_name = device_busy(prof)
    out["link_stream_profile"] = {"wall_us": wall_us, "device_us": busy or None,
                                  "idle_pct": 100.0 - 100.0 * busy / wall_us if busy else None}
    if busy:
        log(f"phase3c profile of one forced-device-form stream (local acks): wall {wall_us:.1f} us, "
            f"device busy {busy:.1f} us, idle {out['link_stream_profile']['idle_pct']:.2f} %; "
            + "; ".join(f"{k} x{c} {t:.1f} us" for k, c, t in by_name[:4]))
    else:
        log("phase3c profile of the forced-form stream: the profiler saw no device time (not measured)")
    shutdown_host_plane()
    return out, k1, k2


# -- phase 3d: the combo channels and load balancers ---------------------------

COMBO_PARTS = 4  # ParallelChannel and PartitionChannel width (the JAX tests' 4 partitions)
COMBO_QUANT_CALLS = 4
LB_CALLS = 60
LA_SLOW_S = 0.010  # the fixed sleep of the slowed server's handler in (c)
SELECTIVE_CALLS, SELECTIVE_STOP_AT = 30, 10
DPC_CALLS = 40
COMBO_METHODS = {0: "echo", 3: "x2", 5: "plus10"}


class ComboServer:
    """One port Server on the card for phase 3d: "tensor.echo" through an
    echo-table endpoint (K1a + K1c), "mixed" {0, 3, 5} through a method
    table endpoint, "quant.pmean" (the int8 quantized pmean device
    method), and "lb.echo": the echo table counted, slowed by
    ``LA_SLOW_S`` while ``slow`` is set."""

    def __init__(self, index, svc, quant):
        from incubator_brpc_tpu_torch.rpc import Server, device_method
        from incubator_brpc_tpu_torch.transport.device import DeviceEndpoint

        self.index, self.calls, self.closed, self.slow = index, 0, False, False
        self.echo_ep = DeviceEndpoint(window_size=16, max_batch=16)
        self.mixed_ep = DeviceEndpoint(service=svc, window_size=16, max_batch=16)
        echo = self.echo_ep.server_handler()

        def lb_echo(cntl, request):
            self.calls += 1
            if self.slow:
                time.sleep(LA_SLOW_S)
            return echo(cntl, request)

        self.server = Server()
        self.server.add_service("tensor", {"echo": echo})
        self.server.add_service("mixed", {name: self.mixed_ep.server_handler(method_id=mid)
                                          for mid, name in COMBO_METHODS.items()})
        self.server.add_service("quant", {"pmean": device_method(quant.kernel, width=QUANT_WIDTH,
                                                                 chunkable=True)})
        self.server.add_service("lb", {"echo": lb_echo})
        if not self.server.start(0):
            raise AssertionError("a phase 3d Server did not start")
        self.echo_ep.warm(256)
        self.mixed_ep.warm(256)

    @property
    def port(self):
        return self.server.port

    def close(self):
        if self.closed:
            return
        self.closed = True
        self.server.stop()
        self.server.join(timeout=60)
        for ep in (self.echo_ep, self.mixed_ep):
            if not ep.close(timeout=120):
                raise AssertionError("a phase 3d endpoint did not settle its calls")


def fanout_calls(pc, service, n_threads, per_thread, parts, mid_of, rng_seed):
    """n_threads x per_thread fan-outs of ``service`` (256 B) through
    ``pc``; each merged answer must be ``parts`` copies of expected() in
    channel order. Returns (fan-outs/s, mean latency in µs)."""
    from incubator_brpc_tpu_torch.rpc import Controller

    rng = np.random.default_rng(rng_seed)
    payloads = [[rng.integers(0, 256, size=256, dtype=np.uint8).tobytes()
                 for _ in range(per_thread)] for _ in range(n_threads)]
    lat = []
    lock = threading.Lock()

    def caller(i):
        for j in range(per_thread):
            mid = mid_of(i, j)
            p = payloads[i][j]
            t0 = time.perf_counter()
            cntl = pc.call_method(service, COMBO_METHODS[mid], p, cntl=Controller(timeout_ms=300_000))
            dt = time.perf_counter() - t0
            want = expected(np.frombuffer(p, np.uint32), mid).tobytes() * parts
            if not cntl.ok() or cntl.response_payload != want:
                raise AssertionError(f"fan-out ({i},{j}) {service}.{COMBO_METHODS[mid]}: code "
                                     f"{cntl.error_code} {cntl.error_text}, merged answer "
                                     f"{'right' if cntl.response_payload == want else 'wrong'}")
            with lock:
                lat.append(dt)

    t0 = time.perf_counter()
    call_threads(n_threads, caller)
    wall = time.perf_counter() - t0
    return len(lat) / wall, 1e6 * sum(lat) / len(lat)


def profile_fanout_burst(torch, pc):
    """torch.profiler over a 16 x 8 burst of fan-outs (256 B echo): wall
    time, device busy time and the idle share."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fanout_calls(pc, "tensor", 16, 8, COMBO_PARTS, lambda i, j: 0, 40)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy, by_name = device_busy(prof)
    if not busy:
        log("phase3d profile of the fan-out burst: the profiler saw no device time (not measured)")
        return {"wall_us": wall_us, "device_us": None, "idle_pct": None}
    idle = 100.0 - 100.0 * busy / wall_us
    log(f"phase3d profile of the 16 x 8 fan-out burst over the links (4 sub-calls each, 256 B): "
        f"wall {wall_us:.1f} us, device busy {busy:.1f} us, idle {idle:.3f} %; "
        + "; ".join(f"{k} x{c} {t:.1f} us" for k, c, t in by_name[:6]))
    return {"wall_us": wall_us, "device_us": busy, "idle_pct": idle}


def k1_launched(kernels, part):
    """Read the launch counts after a part of phase 3d; K1a and K1c must have run."""
    counts = kernels.launch_counts()
    missing = [name for name in ("frame_rows", "echo_step_rows") if counts[name] == 0]
    if missing:
        raise AssertionError(f"phase3d {part}: kernels not launched: {missing}")
    return {name: counts[name] for name in K1}


def combo_phase(torch, kernels, svc):
    """Phase 3d: the combo channels and load balancers over device links on
    the card, servers on cuda:0 (every sub-link shares the card, so each
    takes the host swap and the fused lowering does not arise): (a) a
    ParallelChannel over 4 servers, transport="tpu" and TCP; (b) a
    PartitionChannel from list:// with i/4 tags over the quantized pmean
    device method; (c) an LB channel over 3 servers, rr and la; (e) a
    DynamicPartitionChannel with a 3- and a 2-partition scheme; (d) a
    SelectiveChannel over 3 servers, one stopped mid-run. The launch
    counts are set to zero before each part and read after it. Returns
    (detail, {part: launch counts})."""
    from incubator_brpc_tpu_torch.parallel import quantized as Q
    from incubator_brpc_tpu_torch.rpc import (
        Channel, ChannelOptions, Controller, DynamicPartitionChannel, ParallelChannel,
        PartitionChannel, SelectiveChannel, shutdown_host_plane,
    )
    from incubator_brpc_tpu_torch.rpc import combo

    tpu = dict(transport="tpu", timeout_ms=300_000)
    quant = Q.quantized_pmean_dm(QUANT_WIDTH, QUANT_MODE, QUANT_BLOCK)
    servers = [ComboServer(i, svc, quant) for i in range(5)]
    out, launches = {}, {}
    closers = []
    try:
        # (a) ParallelChannel over 4 servers, over the links and over TCP
        def parallel(transport):
            pc = ParallelChannel()
            for s in servers[:COMBO_PARTS]:
                ch = Channel()
                ch.init(f"127.0.0.1:{s.port}", options=ChannelOptions(
                    **(tpu if transport == "tpu" else {"timeout_ms": 300_000})))
                pc.add_channel(ch)
            return pc

        pcs = {t: parallel(t) for t in ("tpu", "tcp")}
        for pc in pcs.values():  # warm-up (the handshakes), off the count
            fanout_calls(pc, "tensor", 4, 1, COMBO_PARTS, lambda i, j: 0, 41)
            fanout_calls(pc, "mixed", 4, 1, COMBO_PARTS, lambda i, j: 0, 41)
        kernels.reset_launch_counts()
        fan0 = combo.host_fanouts.get_value()
        for t, pc in pcs.items():
            rng = np.random.default_rng(42)
            it = iter([rng.integers(0, 256, 256, dtype=np.uint8).tobytes() for _ in range(20)])

            def one():
                p = next(it)
                cntl = pc.call_method("tensor", "echo", p, cntl=Controller(timeout_ms=300_000))
                if not cntl.ok() or cntl.response_payload != p * COMBO_PARTS:
                    raise AssertionError(f"phase3d (a) {t} fan-out: code {cntl.error_code}")

            out[f"fanout_seq_us_{t}"] = sequential_us(one, 20)
            out[f"fanout_qps_{t}"], out[f"fanout_lat_us_{t}"] = fanout_calls(
                pc, "mixed", 16, 8, COMBO_PARTS, lambda i, j: (0, 3, 5)[(i + j) % 3], 43)
        out["fanout_profile"] = profile_fanout_burst(torch, pcs["tpu"])
        launches["a"] = k1_launched(kernels, "(a)")
        fanouts = combo.host_fanouts.get_value() - fan0
        if fanouts != 2 * (20 + 16 * 8) + 16 * 8:
            raise AssertionError(f"phase3d (a): {fanouts} host fan-outs counted")
        links = [sub[0]._device_sock.link for sub in pcs["tpu"]._subs]
        if len({id(lk) for lk in links}) != COMBO_PARTS or any(lk._step is not None for lk in links):
            raise AssertionError("phase3d (a): want one host-swap link a sub-channel")
        log(f"phase3d (a) ParallelChannel over {COMBO_PARTS} servers (each the echo table through "
            f"its own DeviceEndpoint.server_handler(), window 16), 256 B: 20 sequential fan-outs "
            f"over the links {out['fanout_seq_us_tpu']:.1f} us a fan-out, over TCP "
            f"{out['fanout_seq_us_tcp']:.1f}; {{0,3,5}} 16 threads x 8 fan-outs over the links "
            f"{out['fanout_qps_tpu']:.1f} fan-outs/s (mean {out['fanout_lat_us_tpu']:.1f} us), "
            f"over TCP {out['fanout_qps_tcp']:.1f} fan-outs/s (mean {out['fanout_lat_us_tcp']:.1f} "
            f"us); every merged answer the {COMBO_PARTS} expected() in channel order; "
            f"{fanouts} host fan-outs counted (links on one card: no fused lowering); "
            f"launches {[launches['a'][n] for n in K1]} ({', '.join(K1)})")

        # (b) PartitionChannel from list:// with i/4 tags over the quantized pmean
        url = "list://" + ",".join(f"127.0.0.1:{s.port} {i}/{COMBO_PARTS}"
                                   for i, s in enumerate(servers[:COMBO_PARTS]))
        part = PartitionChannel()
        if not part.init(url, partition_count=COMBO_PARTS, options=ChannelOptions(**tpu)):
            raise AssertionError("phase3d (b): PartitionChannel.init failed")
        closers.append(part.stop)
        rng = np.random.default_rng(44)
        reqs = [(rng.standard_normal(QUANT_WIDTH // 4) * 10 ** rng.uniform(-3, 3))
                .astype(np.float32).tobytes() for _ in range(COMBO_QUANT_CALLS + 1)]
        cntl = part.call_method("quant", "pmean", reqs[0], cntl=Controller(timeout_ms=300_000))
        if not cntl.ok():  # warm-up, off the count
            raise AssertionError(f"phase3d (b): code {cntl.error_code} {cntl.error_text}")
        kernels.reset_launch_counts()
        fan0 = combo.host_fanouts.get_value()
        t0 = time.perf_counter()
        for req in reqs[1:]:
            cntl = part.call_method("quant", "pmean", req, cntl=Controller(timeout_ms=300_000))
            if not cntl.ok() or cntl.response_payload != link_device_method_expected(req) * COMBO_PARTS:
                raise AssertionError(f"phase3d (b): code {cntl.error_code}, merged answer not "
                                     f"{COMBO_PARTS} copies of the numpy twin's")
        out["partition_quant_us"] = 1e6 * (time.perf_counter() - t0) / COMBO_QUANT_CALLS
        counts = kernels.launch_counts()
        launches["b"] = {name: counts[name] for name in K2}
        if list(launches["b"].values()) != [COMBO_PARTS * COMBO_QUANT_CALLS] * len(K2):
            raise AssertionError(f"phase3d (b): K2 launches {launches['b']}, want "
                                 f"{COMBO_PARTS} each a fan-out")
        if combo.host_fanouts.get_value() - fan0 != COMBO_QUANT_CALLS:
            raise AssertionError("phase3d (b): the device-method fan-out did not take the host fan-out")
        log(f"phase3d (b) PartitionChannel (list://, tags i/{COMBO_PARTS}) over the quantized pmean "
            f"device method ({QUANT_MODE}, width {QUANT_WIDTH}, block {QUANT_BLOCK}) over the links: "
            f"{COMBO_QUANT_CALLS} fan-outs, each {COMBO_PARTS} copies of np_quantized_pmean bitwise, "
            f"{out['partition_quant_us']:.1f} us a fan-out; K2 launches {list(launches['b'].values())} "
            f"({', '.join(K2)}: {COMBO_PARTS} each a fan-out); the device method's preconditions "
            "fail at the shared card, so the host fan-out ran")

        # (c) an LB channel over 3 device servers: rr, then la with server 2 slowed
        lb_url = "list://" + ",".join(f"127.0.0.1:{s.port}" for s in servers[:3])
        kernels.reset_launch_counts()
        payload = bytes(range(256))
        for name in ("rr", "la"):
            ch = Channel()
            if not ch.init(lb_url, name, ChannelOptions(**tpu)):
                raise AssertionError(f"phase3d (c): Channel.init({name}) failed")
            closers.append(ch._lb.stop)
            for s in servers[:3]:
                s.calls = 0
            servers[2].slow = name == "la"
            lat = []
            for _ in range(LB_CALLS):
                t0 = time.perf_counter()
                cntl = ch.call_method("lb", "echo", payload)
                lat.append(1e6 * (time.perf_counter() - t0))
                if not cntl.ok() or cntl.response_payload != payload:
                    raise AssertionError(f"phase3d (c) {name}: code {cntl.error_code}")
            out[f"lb_{name}_us"] = sum(lat) / LB_CALLS
            out[f"lb_{name}_median_us"] = float(np.median(lat))
            out[f"lb_{name}_first_us"] = lat[0]
            out[f"lb_{name}_calls"] = [s.calls for s in servers[:3]]
        servers[2].slow = False
        if out["lb_rr_calls"] != [LB_CALLS // 3] * 3:
            raise AssertionError(f"phase3d (c) rr: calls a server {out['lb_rr_calls']}")
        la = out["lb_la_calls"]
        if la[2] != min(la) or la.count(la[2]) != 1:
            raise AssertionError(f"phase3d (c) la: calls a server {la}, the slowed server 2 not the fewest")
        launches["c"] = k1_launched(kernels, "(c)")
        log(f"phase3d (c) Channel.init(list:// of 3 device servers, lb, transport=tpu), {LB_CALLS} "
            f"calls of 256 B: rr {out['lb_rr_calls']} calls a server, {out['lb_rr_us']:.1f} us a "
            f"call (median {out['lb_rr_median_us']:.1f}, the first {out['lb_rr_first_us']:.1f}); "
            f"la with server 2 slowed by {LA_SLOW_S * 1e3:.0f} ms {la}, {out['lb_la_us']:.1f} us a "
            f"call (median {out['lb_la_median_us']:.1f}); launches {[launches['c'][n] for n in K1]}")

        # (e) DynamicPartitionChannel: a 3-partition and a 2-partition scheme
        dpc_url = "list://" + ",".join(
            [f"127.0.0.1:{s.port} {i}/3" for i, s in enumerate(servers[:3])]
            + [f"127.0.0.1:{s.port} {i}/2" for i, s in enumerate(servers[3:5])])
        dpc = DynamicPartitionChannel()
        if not dpc.init(dpc_url, options=ChannelOptions(**tpu)):
            raise AssertionError("phase3d (e): DynamicPartitionChannel.init failed")
        closers.append(dpc.stop)
        kernels.reset_launch_counts()
        seen = {2: 0, 3: 0}
        rng = np.random.default_rng(45)
        t0 = time.perf_counter()
        for _ in range(DPC_CALLS):
            p = rng.integers(0, 256, 256, dtype=np.uint8).tobytes()
            cntl = dpc.call_method("tensor", "echo", p, cntl=Controller(timeout_ms=300_000))
            n = len(cntl.response_payload) // len(p)
            if not cntl.ok() or n not in seen or cntl.response_payload != p * n:
                raise AssertionError(f"phase3d (e): code {cntl.error_code}, a merged answer of "
                                     f"{len(cntl.response_payload)} B")
            seen[n] += 1
        out["dpc_us"] = 1e6 * (time.perf_counter() - t0) / DPC_CALLS
        out["dpc_schemes"] = {f"/{k}": v for k, v in seen.items()}
        if not all(seen.values()):
            raise AssertionError(f"phase3d (e): a scheme never served: {seen}")
        launches["e"] = k1_launched(kernels, "(e)")
        log(f"phase3d (e) DynamicPartitionChannel (tags i/3 on servers 0-2, i/2 on 3-4, "
            f"transport=tpu), {DPC_CALLS} calls of 256 B: scheme /3 served {seen[3]}, /2 {seen[2]}, "
            f"every merged answer bitwise; {out['dpc_us']:.1f} us a call; launches "
            f"{[launches['e'][n] for n in K1]}")

        # (d) SelectiveChannel over 3 device servers, server 4 stopped mid-run
        sel = SelectiveChannel()
        for s in servers[2:5]:
            ch = Channel()
            ch.init(f"127.0.0.1:{s.port}", options=ChannelOptions(**tpu))
            sel.add_channel(ch)
        t0 = time.perf_counter()
        for k in range(SELECTIVE_CALLS):
            if k == SELECTIVE_STOP_AT:
                servers[4].close()
            cntl = sel.call_method("tensor", "echo", payload, cntl=Controller(timeout_ms=300_000))
            if not cntl.ok() or cntl.response_payload != payload:
                raise AssertionError(f"phase3d (d) call {k}: code {cntl.error_code} {cntl.error_text}")
        out["selective_us"] = 1e6 * (time.perf_counter() - t0) / SELECTIVE_CALLS
        out["selective_health"] = sel.health()
        if not out["selective_health"][2]["down"]:
            raise AssertionError(f"phase3d (d): the stopped server's sub-channel is not down: "
                                 f"{out['selective_health']}")
        log(f"phase3d (d) SelectiveChannel over 3 device servers, server 4 stopped before call "
            f"{SELECTIVE_STOP_AT} of {SELECTIVE_CALLS}: every call answered, {out['selective_us']:.1f} "
            f"us a call; the stopped server's sub-channel down (fail streak "
            f"{out['selective_health'][2]['fail_streak']})")
    finally:
        for close in closers:
            close()
        for s in servers:
            s.close()
        shutdown_host_plane()
    return out, launches


# -- phase 3e: streaming RPC and the multi-controller link across processes ----

STREAM_MSGS = 20  # seeded messages from 1 KiB to 1 MiB
STREAM_MAX_BUF = 256 << 10  # the writer's window, far below the 4.3 MiB the messages total
STREAM_RUNS = ("tcp", "link", "link", "tcp")
MC_PAIR_RPCS = 8
MC_DEVICE_RPCS = 20
MC_BURST = ("--n-rpcs", "4", "--payload", "20000", "--slot-words", "128", "--window", "2")
MC_PROBE_WORDS = (256, 16384)  # the pair's slot width and the link's default
MC_PROBE_ITERS = 50
MC_TIMEOUT_S = 300.0


def stream_messages(seed: int = 41):
    """The stream's messages: seeded sizes from 1 KiB to 1 MiB, seeded bytes."""
    rng = np.random.default_rng(seed)
    sizes = np.round(2.0 ** rng.uniform(10, 20, STREAM_MSGS)).astype(int)
    sizes[0], sizes[-1] = 1 << 10, 1 << 20
    return [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes() for n in sizes]


class StreamCheck:
    """Server half's record of one stream: each message's length and CRC-32
    in arrival order, and when the last arrived."""

    def __init__(self, want: int):
        self.got = []
        self.want = want
        self.done = threading.Event()
        self.t_done = None

    def on_received_messages(self, stream, messages):
        for m in messages:
            self.got.append((len(m), zlib.crc32(m)))
        if len(self.got) >= self.want:
            self.t_done = time.perf_counter()
            self.done.set()

    def on_closed(self, stream):
        pass

    def on_failed(self, stream, code, reason):
        self.done.set()


def stream_run(rpc, ch, checks, msgs):
    """One stream of ``msgs`` over ``ch``: opened by an RPC, written with
    the ``STREAM_MAX_BUF`` window (the writer parks when it is full), every
    message checked in order by its length and CRC-32 at the server.
    Returns (messages/s, MB/s, writes that found the window full)."""
    s = rpc.stream_create(rpc.StreamOptions(max_buf_size=STREAM_MAX_BUF))
    cntl = ch.call_method("stream", "open", b"%d" % len(msgs), request_stream=s)
    if not cntl.ok() or not s.wait_connected(timeout=60):
        raise AssertionError(f"phase3e stream not accepted: code {cntl.error_code} {cntl.error_text}")
    check = checks[int(cntl.response_payload)]
    full = 0
    t0 = time.perf_counter()
    for m in msgs:
        if s.unconsumed_bytes >= STREAM_MAX_BUF:
            full += 1
        rc = s.write(m, timeout=60)
        if rc != 0:
            raise AssertionError(f"phase3e stream write: code {rc}")
    if not check.done.wait(120) or check.t_done is None:
        raise AssertionError(f"phase3e stream: {len(check.got)} of {len(msgs)} messages arrived")
    wall = check.t_done - t0
    if check.got != [(len(m), zlib.crc32(m)) for m in msgs]:
        raise AssertionError("phase3e stream: messages out of order or corrupt")
    s.close()
    return len(msgs) / wall, sum(map(len, msgs)) / wall / 1e6, full


def forced_device_links(dl):
    """While active, the links a handshake builds take the forced device
    form (each step's slots swapped on the card, not the host swap)."""
    class Forced(dl.DeviceLink):
        def __init__(self, devices, slot_words=16384, window=8, host_loopback=None,
                     ack_mode="local"):
            super().__init__(devices, slot_words, window, False, ack_mode)

    return patched([(dl, "DeviceLink", Forced)])


def halves_agree(client_link, server_link, label, device="cuda:0"):
    """Both halves of one link dispatched the same steps and agree on one
    final target; their rows were on ``device``."""
    if (client_link["final_target"] is None
            or client_link["final_target"] != server_link["final_target"]
            or not client_link["steps"] == server_link["steps"] == client_link["final_target"]):
        raise AssertionError(f"{label}: the halves disagree: {client_link} vs {server_link}")
    for half in (client_link, server_link):
        if half["row_device"] != device:
            raise AssertionError(f"{label}: slot rows on {half['row_device']}, not {device}")
        if half["peer_ack"] <= 0:
            raise AssertionError(f"{label}: wire acks never advanced")


def mc_phase(torch, kernels, device="cuda:0"):
    """Phase 3e: (a) streams over TCP and over the forced device form of a
    link on the card; (b) the two-process pair on cuda:0 over gloo: echoes,
    device RPC (K1 counted in the server), the windowed burst and gloo's
    staging; (c) the three-process fabric; (d) peer death. Returns (detail,
    the server's K1 launches). ``device="cpu"`` rehearses it on the CPU
    (tests/test_torch_mc_link.py), where no kernel launches."""
    from incubator_brpc_tpu_torch import rpc
    from incubator_brpc_tpu_torch.transport import device_link as dl
    from incubator_brpc_tpu_torch.transport import mc_worker as mc
    from incubator_brpc_tpu_torch.utils.status import ErrorCode

    out = {}
    # (a) streams
    checks = []
    msgs = stream_messages()

    def open_stream(cntl, request):
        checks.append(StreamCheck(int(request)))
        rpc.stream_accept(cntl, rpc.StreamOptions(handler=checks[-1]))
        return b"%d" % (len(checks) - 1)

    server = rpc.Server(rpc.ServerOptions(device=device))
    server.add_service("stream", {"open": open_stream})
    if not server.start(0):
        raise AssertionError("phase3e: the stream server did not start")
    try:
        chans = {}
        for name, transport in (("tcp", "tcp"), ("link", "tpu")):
            chans[name] = rpc.Channel()
            chans[name].init(f"127.0.0.1:{server.port}",
                             options=rpc.ChannelOptions(transport=transport, timeout_ms=120_000))
        with forced_device_links(dl):
            stream_run(rpc, chans["link"], checks, msgs[:2])  # the handshake, off the clock
        link = chans["link"]._device_sock.link
        if link._step is None or [str(d) for d in link.devices] != [device, device]:
            raise AssertionError(f"phase3e the stream's link is not the forced device form on "
                                 f"{device}: {link.devices}, step {link._step}")
        runs = {"tcp": [], "link": []}
        for name in STREAM_RUNS:
            runs[name].append(stream_run(rpc, chans[name], checks, msgs))
        out["stream"] = {name: [{"msgs_per_s": r[0], "mb_per_s": r[1], "full_writes": r[2]}
                                for r in rs] for name, rs in runs.items()}
        if not all(r[2] > 0 for rs in runs.values() for r in rs):
            raise AssertionError("phase3e: a stream's writer never found its window full")
        log(f"phase3e (a) streams, {STREAM_MSGS} messages of 1 KiB-1 MiB "
            f"({sum(map(len, msgs)) / 2**20:.2f} MiB), window {STREAM_MAX_BUF >> 10} KiB, "
            "every message in order with its CRC-32: "
            + "; ".join(f"{name} " + ", ".join(f"{r[0]:.1f} msgs/s {r[1]:.1f} MB/s ({r[2]} writes "
                                               "found the window full)" for r in rs)
                        for name, rs in runs.items())
            + f"; the link in the forced device form on {device}")
    finally:
        server.stop()
        server.join(timeout=60)
        rpc.shutdown_host_plane()

    # (b) the two-process pair on cuda:0, gloo
    dev = dict(device=device, backend="gloo", timeout=MC_TIMEOUT_S)
    t0 = time.perf_counter()
    pair, _ = mc.orchestrate_pair(extra=("--n-rpcs", str(MC_PAIR_RPCS),
                                         "--device-rpcs", str(MC_DEVICE_RPCS)),
                                  server_extra=("--device-echo",), **dev)
    out["pair_s"] = time.perf_counter() - t0
    srv = pair["servers"]["server"]
    halves_agree(pair, srv["links"][0], "phase3e (b) pair", device)
    if pair["steps"] < MC_PAIR_RPCS or pair["device_rpcs"] != MC_DEVICE_RPCS:
        raise AssertionError(f"phase3e (b) pair: {pair}")
    k1 = srv["k1_launches"]
    missing = [n for n in ("frame_rows", "echo_step_rows") if not k1[n]]
    if missing and device != "cpu":
        raise AssertionError(f"phase3e (b): kernels not launched in the server process: {missing}")
    out["pair"] = pair
    log(f"phase3e (b) two-process pair (ranks {[p[0] for p in pair['parties']]}, both "
        f"{pair['parties'][0][1]}, gloo; slot rows on {pair['row_device']}): {MC_PAIR_RPCS} echoes "
        f"of {pair['payload']} B {pair['echo_ms']:.2f} ms a call ({pair['echo_steps_per_s']:.1f} "
        f"steps/s) and {MC_DEVICE_RPCS} device RPCs "
        f"of the echo table (256 B) bitwise; steps {pair['steps']}, peer_ack {pair['peer_ack']}, "
        f"final_target {pair['final_target']} on both halves; host time per exchange "
        f"{pair['exchange_ms']:.3f} ms (client), {srv['links'][0]['exchange_ms']:.3f} ms (server); "
        f"K1 in the server process {k1}; {out['pair_s']:.1f} s with the processes' start")
    burst, _ = mc.orchestrate_pair(extra=MC_BURST, **dev)
    halves_agree(burst, burst["servers"]["server"]["links"][0], "phase3e (b) burst", device)
    if burst["steps"] <= 160:
        raise AssertionError(f"phase3e (b) burst: {burst['steps']} steps, want > 160")
    out["burst"] = burst
    log(f"phase3e (b) windowed burst (4 x 20000 B, 128-word slots, window 2): steps "
        f"{burst['steps']}, peer_ack {burst['peer_ack']}, final_target {burst['final_target']}, "
        f"host time per exchange {burst['exchange_ms']:.3f} ms, {burst['echo_ms']:.2f} ms an echo "
        f"({burst['echo_steps_per_s']:.1f} steps/s)")
    probe = mc.orchestrate_probe(words=MC_PROBE_WORDS, iters=MC_PROBE_ITERS, **dev)
    out["probe"] = probe
    log(f"phase3e (b) gloo's exchange of {device} rows against host rows, two processes, "
        f"{MC_PROBE_ITERS} exchanges a width: "
        + "; ".join(f"rank {r['rank']} " + ", ".join(
            f"{w} words: " + ", ".join(f"{k} {v:.3f} ms" for k, v in rec.items())
            for w, rec in r["widths"].items()) for r in probe))

    # (c) the three-process fabric
    fabric, _ = mc.orchestrate_fabric(n_servers=2, extra=("--n-rpcs", "8"), **dev)
    for lk in fabric["links"]:
        halves_agree(lk, fabric["servers"][f"server{lk['parties'][1][0]}"]["links"][0],
                     "phase3e (c) fabric", device)
    out["fabric"] = fabric
    log(f"phase3e (c) three-process fabric, PartitionChannel over two multi links from rank "
        f"{fabric['links'][0]['parties'][0][0]}: 8 fan-outs {fabric['fanout_ms']:.2f} ms each; "
        + "; ".join(f"link to rank {lk['parties'][1][0]} steps {lk['steps']}, peer_ack "
                    f"{lk['peer_ack']}, final_target {lk['final_target']}" for lk in fabric["links"]))

    # (d) peer death
    death, transcript = mc.orchestrate_peer_death(die_after=3, **dev)
    if death["error_code"] != ErrorCode.EFAILEDSOCKET or "SERVER_DYING" not in transcript:
        raise AssertionError(f"phase3e (d) peer death: {death}")
    out["peer_death"] = death
    log(f"phase3e (d) peer death: the server process exited inside call {death['failed_at']}; "
        f"the call failed with EFAILEDSOCKET after {1e3 * death['fail_s']:.1f} ms "
        f"({death['ok_before_death']} calls answered before)")
    return out, k1


# -- K3 and the FabricNet train step (phases 5-8) -----------------------------


# -- phase 3f: the native host runtime (C++ reactors, native client) ------------

NATIVE_SEQ = (3000, 5)  # bench_native_plane's sequential 64 B echo: calls x runs
NATIVE_THREADS = (8, 2000)  # its 8 callers x 2000 calls
NATIVE_PUMP = (2000, 64)  # a pump of 2000 requests at 64 in flight
NATIVE_SWEEP_PER_CONN = 60000  # bench_native_scaling's requests a connection


def host_cpus() -> int:
    try:
        return len(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        return os.cpu_count() or 1


def native_twins_check(scale: float = 1.0) -> dict:
    """Hold the host runtime's CRC32C, CRC32, FlatMap, ResourcePool and
    IOBuf cut against their plain twins on seeded data; time CRC32C of a
    32 KiB body natively and in its plain version."""
    from incubator_brpc_tpu_torch import iobuf, native
    from incubator_brpc_tpu_torch.protocol import tbus_std
    from incubator_brpc_tpu_torch.utils.crc32c import crc32c_plain

    rng = np.random.default_rng(31)
    seed32 = seed32c = 0
    lengths = [0, 1, 7, 64, 255, 4096, 32768, 65536]
    for n in lengths:
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        a, b = native.crc32c(data, seed32c), crc32c_plain(data, seed32c)
        if a != b:
            raise AssertionError(f"phase3f crc32c of {n} B: native {a:#x}, plain {b:#x}")
        c, d = native.crc32(data, seed32), zlib.crc32(data, seed32) & 0xFFFFFFFF
        if c != d:
            raise AssertionError(f"phase3f crc32 of {n} B: native {c:#x}, zlib {d:#x}")
        seed32, seed32c = c, a
    fm, model = native.FlatMap(16), {}
    for op, key, val in zip(rng.integers(0, 3, int(20000 * scale)),
                            rng.integers(0, 4096, int(20000 * scale)),
                            rng.integers(0, 1 << 62, int(20000 * scale))):
        key, val = int(key), int(val)
        if op == 0:
            fm[key] = model[key] = val
        elif op == 1 and key in model:
            del fm[key], model[key]
        if fm.get(key) != model.get(key) or len(fm) != len(model):
            raise AssertionError(f"phase3f FlatMap disagrees with a dict at key {key}")
    pool, live = native.ResourcePool(8), set()
    for _ in range(int(5000 * scale)):
        if live and rng.random() < 0.45:
            rid = sorted(live)[int(rng.integers(0, len(live)))]
            live.discard(rid)
            if not pool.return_(rid) or pool.address(rid) is not None or pool.return_(rid):
                raise AssertionError("phase3f ResourcePool: a returned id still addresses")
        else:
            rid = pool.get()
            if rid in live or pool.address(rid) is None:
                raise AssertionError("phase3f ResourcePool: a fresh id is live twice or dead")
            live.add(rid)
        if pool.live != len(live):
            raise AssertionError(f"phase3f ResourcePool live {pool.live}, model {len(live)}")
    nat, plain = iobuf._NativeIOBuf(), iobuf._PyIOBuf()
    for step in range(int(400 * scale)):
        n = int(rng.integers(1, 20000))
        if step % 3 == 2:
            a, b = nat.cutn(n), plain.cutn(n)
            if a.to_bytes() != b.to_bytes():
                raise AssertionError("phase3f native IOBuf cut differs from the plain cut")
        else:
            data = rng.bytes(n)
            nat.append(data)
            plain.append(data)
        if nat.to_bytes() != plain.to_bytes():
            raise AssertionError("phase3f native IOBuf differs from the plain chain")
    for body_crc in (0, tbus_std.FLAG_BODY_CRC):
        meta = tbus_std.Meta(service="tensor", method="echo", timeout_ms=1000)
        frame = tbus_std.pack_frame(meta, rng.bytes(40000), 9, flags=body_crc,
                                    attachment=rng.bytes(100))
        got = []
        for chain, cut in ((iobuf._NativeIOBuf, tbus_std.parse_frame_iobuf),
                           (iobuf._PyIOBuf, tbus_std.parse_frame_iobuf_plain)):
            buf = chain()
            buf.append(frame)
            f, used = cut(buf)
            got.append((used, f.payload, f.attachment, f.correlation_id))
        if got[0] != got[1] or tbus_std.pack_frame_iobuf(
                meta, got[0][1], 9, flags=body_crc, attachment=got[0][2]).to_bytes() != frame:
            raise AssertionError("phase3f native tbus_std pack or cut differs from the plain one")
    body = bytes(range(256)) * 128
    out = {
        "crc32c_32k_native_us": sequential_us(lambda: native.crc32c(body), 200),
        "crc32c_32k_plain_us": sequential_us(lambda: crc32c_plain(body), 5),
    }
    return out


def native_host_echo(scale: float = 1.0) -> dict:
    """bench_native_plane's and bench_native_scaling's host echo geometries
    through the port's API: a native-plane Server with ``native_echo``."""
    from incubator_brpc_tpu_torch.rpc import (Channel, ChannelOptions, Server, ServerOptions,
                                              native_echo)
    from incubator_brpc_tpu_torch.transport import native_plane as np_mod

    def start(**kw):
        srv = Server(ServerOptions(native_plane=True, usercode_inline=True, device="cpu", **kw))
        srv.add_service("bench", {"echo": native_echo, "py": lambda cntl, req: req})
        if not srv.start(0) or srv._native_plane is None:
            raise AssertionError("phase3f: the native plane did not engage")
        return srv

    out = {"host_cpus": host_cpus()}
    payload = b"x" * 64
    srv = start(num_reactors=2)
    try:
        ch = Channel()
        ch.init(f"127.0.0.1:{srv.port}", options=ChannelOptions(native_plane=True))

        def one(method="echo", p=payload):
            cntl = ch.call_method("bench", method, p)
            if not cntl.ok() or cntl.response_payload != p:
                raise AssertionError(f"phase3f echo: code {cntl.error_code} {cntl.error_text}")

        for _ in range(100):
            one()
        calls, runs = max(1, int(NATIVE_SEQ[0] * scale)), NATIVE_SEQ[1]
        out["seq_calls"], out["threads_calls"] = calls, max(1, int(NATIVE_THREADS[1] * scale))
        out["echo_64_us"] = [sequential_us(one, calls) for _ in range(runs)]
        p256 = bytes(range(256))
        out["echo_256_native_us"] = sequential_us(lambda: one("echo", p256), calls)
        out["echo_256_python_route_us"] = sequential_us(lambda: one("py", p256), calls)
        nthreads, per = NATIVE_THREADS[0], out["threads_calls"]
        t0 = time.perf_counter()
        call_threads(nthreads, lambda i: [one() for _ in range(per)])
        out["echo_8x2000_qps"] = nthreads * per / (time.perf_counter() - t0)
        if ch._native_ch is None:
            raise AssertionError("phase3f: the Channel did not take the native client")
        nch = np_mod.NativeClientChannel("127.0.0.1", srv.port)
        try:
            n, inflight = max(64, int(NATIVE_PUMP[0] * scale)), NATIVE_PUMP[1]
            nch.pump("bench", "echo", payload, n, inflight=inflight)  # warm
            out["pump_ns"] = [nch.pump("bench", "echo", payload, n, inflight=inflight)
                              for _ in range(5)]
            big = b"x" * 32768
            ns32 = [nch.pump("bench", "echo", big, max(32, int(10000 * scale)), inflight=32)
                    for _ in range(3)]
            # the payload crosses the loopback twice a request
            out["echo_32k_gbps"] = [2 * len(big) / v for v in ns32]
        finally:
            nch.close()
        if srv._native_plane.stats()["native_reqs"] <= 0:
            raise AssertionError("phase3f: no request was answered natively")
    finally:
        srv.stop()
        srv.join(timeout=60)
    sweep = {}
    per_conn = max(64, int(NATIVE_SWEEP_PER_CONN * scale))
    for reactors in (1, 2, 4):
        srv = start(num_reactors=reactors)
        try:
            for conns in (1, 2, 4):
                chans = [np_mod.NativeClientChannel("127.0.0.1", srv.port) for _ in range(conns)]
                try:
                    for nc in chans:
                        nc.pump("bench", "echo", payload, 2000, inflight=64)
                    best = 0.0
                    for _rep in range(3):
                        t0 = time.perf_counter()
                        call_threads(conns, lambda i: chans[i].pump(
                            "bench", "echo", payload, per_conn, inflight=128))
                        best = max(best, conns * per_conn / (time.perf_counter() - t0))
                    sweep[f"r{reactors}c{conns}"] = best
                finally:
                    for nc in chans:
                        nc.close()
        finally:
            srv.stop()
            srv.join(timeout=60)
    out["pump_qps_sweep"], out["sweep_per_conn"] = sweep, per_conn
    return out


NATIVE_RPC_CONFIGS = {
    # config -> (server, client's native_plane): the Python plane (phase
    # 3b's), the native plane from the Python Channel and from the native
    # client, and the native plane with the handler on the reactor thread
    "python_plane": ("python", False),
    "native_plane_python_channel": ("native", False),
    "native_plane_native_client": ("native", True),
    "native_plane_inline_native_client": ("inline", True),
}


def native_device_rpc(torch, kernels, device=None, scale: float = 1.0):
    """Phase 3b's device RPC (256 B, window 16), one
    ``DeviceEndpoint.server_handler()`` behind three servers: the Python
    plane (phase 3b's), a native-plane Server (the C++ reactors cut each
    frame and hand it to the Python route, which runs the handler on the
    worker pool) and one with ``usercode_inline=True`` (the handler on the
    reactor's callback). ``NATIVE_RPC_CONFIGS`` pairs them with the Python
    Channel or the native client. In turns (each configuration twice, in
    mirrored order, so drift on the shared host falls on both sides): 20
    sequential calls each (µs a call and inside the handler), then 16
    threads x 8 calls each but the inline server's (a handler that blocks
    on the card stalls its reactor), every answer bitwise ``expected()``;
    on the card torch.profiler over one burst of each native-plane
    configuration. The K1 launches are tallied per configuration around
    each of its blocks. Returns (figures, the K1 launches of the
    native-plane configurations)."""
    from incubator_brpc_tpu_torch.rpc import Channel, ChannelOptions, Server, ServerOptions
    from incubator_brpc_tpu_torch.transport.device import DeviceEndpoint

    ep = DeviceEndpoint(window_size=16, max_batch=16, device=device)
    handler = ep.server_handler()
    handler_s = []  # seconds inside the endpoint's handler, call by call

    def timed(cntl, request):
        t0 = time.perf_counter()
        try:
            return handler(cntl, request)
        finally:
            handler_s.append(time.perf_counter() - t0)

    tally = {name: dict.fromkeys(K1, 0) for name in NATIVE_RPC_CONFIGS}

    def counted(name, fn):
        before = kernels.launch_counts()
        result = fn()
        after = kernels.launch_counts()
        for k in K1:
            tally[name][k] += after[k] - before[k]
        return result

    kernels.reset_launch_counts()
    servers = {
        "python": Server(ServerOptions(device=device)),
        "native": Server(ServerOptions(native_plane=True, device=device)),
        "inline": Server(ServerOptions(native_plane=True, usercode_inline=True, device=device)),
    }
    out = {"seq_us": {}, "handler_us": {}, "qps": {}, "lat_us": {}, "profile": {}}
    try:
        for kind, srv in servers.items():
            srv.add_service("tensor", {"echo": timed})
            if not srv.start(0) or (srv._native_plane is None) != (kind == "python"):
                raise AssertionError(f"phase3f (c): the {kind} server did not start as asked")
        ep.warm(256)
        chans = {}
        for name, (kind, native_client) in NATIVE_RPC_CONFIGS.items():
            ch = Channel()
            ch.init(f"127.0.0.1:{servers[kind].port}",
                    options=ChannelOptions(timeout_ms=300_000, native_plane=native_client))
            chans[name] = ch
            if kind != "inline":  # warm-up
                counted(name, lambda: rpc_calls(ch, "tensor", 16, 2, 256, lambda i, j: 0, 30))
        order = list(NATIVE_RPC_CONFIGS)
        for turn, name in enumerate(order + order[::-1]):
            ch = chans[name]
            rng = np.random.default_rng(32 + turn)
            seq = iter([rng.integers(0, 256, size=256, dtype=np.uint8).tobytes()
                        for _ in range(20)])

            def one():
                p = next(seq)
                cntl = ch.call_method("tensor", "echo", p)
                if not cntl.ok() or cntl.response_payload != p:
                    raise AssertionError(f"phase3f (c) {name}: code {cntl.error_code}")

            del handler_s[:]
            out["seq_us"].setdefault(name, []).append(counted(name, lambda: sequential_us(one, 20)))
            out["handler_us"].setdefault(name, []).append(1e6 * sum(handler_s) / len(handler_s))
            if (ch._native_ch is not None) != NATIVE_RPC_CONFIGS[name][1]:
                raise AssertionError(f"phase3f (c) {name}: the call took the wrong client")
        per = max(1, int(8 * scale))
        bursts = [n for n in order if NATIVE_RPC_CONFIGS[n][0] != "inline"]
        for name in bursts + bursts[::-1]:
            qps, lat = counted(name, lambda: rpc_calls(chans[name], "tensor", 16, per, 256,
                                                       lambda i, j: 0, 33))
            out["qps"].setdefault(name, []).append(qps)
            out["lat_us"].setdefault(name, []).append(lat)
        if device is None or str(device).startswith("cuda"):
            for name in bursts[1:]:
                out["profile"][name] = counted(name, lambda: profile_rpc_burst(
                    torch, chans[name], f"phase3f (c) {name}"))
        out["stats"] = servers["native"]._native_plane.stats()
    finally:
        for srv in servers.values():
            srv.stop()
            srv.join(timeout=60)
        if not ep.close(timeout=120):
            raise AssertionError("phase3f (c): the endpoint did not settle its calls")
    out["launches"] = tally
    k1 = {k: sum(tally[n][k] for n, (kind, _) in NATIVE_RPC_CONFIGS.items() if kind != "python")
          for k in K1}
    return out, k1


def native_phase(torch, kernels, rpc3b, device=None, scale: float = 1.0):
    """Phase 3f: the port's native host runtime. (a) g++ builds
    ``csrc/host`` again into a scratch file (compiler, seconds, whether
    ``zlib.h`` was found) and its CRC32C, CRC32, FlatMap, ResourcePool and
    IOBuf cut are held against their plain twins; (b) the host echo
    geometries of ``bench_native_plane`` and ``bench_native_scaling``
    through the port's API, beside the host's CPU count; (c) phase 3b's
    device RPC behind the native plane beside the Python plane, in turns
    (``native_device_rpc``), K1 counted. Every figure is printed beside
    phase 3b's from the same run. Returns (figures, the K1 launches of
    (c)'s native-plane configurations); the caller asserts K1a and K1c
    launched."""
    from incubator_brpc_tpu_torch import native

    if not native.NATIVE_AVAILABLE:
        raise AssertionError(f"phase3f: the host runtime did not build:\n{native.BUILD_ERROR}")
    scratch = native.BUILD_DIR / f"phase3f-{os.getpid()}.so"
    try:
        build = native.compile_library(scratch)
    finally:
        scratch.unlink(missing_ok=True)
    build.pop("log")
    build["zlib_h"] = native.zlib_header_found()
    build["loaded"] = native.library_path().name
    log(f"phase3f (a) host runtime: {build['compiler']}; g++ of csrc/host (tbutil.cc + tbnet.cc) "
        f"{build['seconds']:.1f} s; zlib.h found: {build['zlib_h']}; loaded "
        f"{build['loaded']} (built by this process at import: "
        f"{'%.1f s' % native.BUILD_INFO['seconds'] if 'seconds' in native.BUILD_INFO else 'no, cached'})")
    out = {"build": build}
    out["twins"] = native_twins_check(scale)
    log(f"phase3f (a) CRC32C, CRC32, FlatMap, ResourcePool, the IOBuf cut and tbus_std's pack and "
        f"cut equal to their plain twins on seeded data; CRC32C of 32 KiB: native "
        f"{out['twins']['crc32c_32k_native_us']:.2f} us, plain {out['twins']['crc32c_32k_plain_us']:.1f} us")
    host = native_host_echo(scale)
    out["host"] = host
    sweep = host["pump_qps_sweep"]
    best = {r: max(v for k, v in sweep.items() if k.startswith(f"r{r}c")) for r in (1, 2, 4)}
    log(f"phase3f (b) host echo on the native plane ({host['host_cpus']} CPUs for this process): "
        f"64 B sequential through ChannelOptions(native_plane=True), {host['seq_calls']} calls x "
        f"{NATIVE_SEQ[1]}: " + ", ".join(f"{v:.2f}" for v in host["echo_64_us"]) + " us a call; "
        f"256 B {host['echo_256_native_us']:.2f} us (native_echo), "
        f"{host['echo_256_python_route_us']:.2f} us (a Python handler through the C++ reactor), "
        f"the Python plane's host echo {rpc3b['host_echo_seq_us']:.1f} us (phase 3b); "
        f"8 threads x {host['threads_calls']}: {host['echo_8x2000_qps']:.0f} calls/s "
        f"(the Python plane's 16 x 8 host echo {rpc3b['host_echo_qps']:.1f} calls/s); pump of "
        f"{NATIVE_PUMP[0]} at {NATIVE_PUMP[1]} in flight: "
        + ", ".join(f"{v:.0f}" for v in host["pump_ns"]) + " ns a request; 32 KiB echo "
        + ", ".join(f"{v:.3f}" for v in host["echo_32k_gbps"]) + " GB/s; reactor sweep (best of 3, "
        f"{host['sweep_per_conn']} a connection, 1/2/4 connections): "
        + "; ".join(f"{k} {v:.0f}/s" for k, v in sweep.items())
        + f"; best 4-reactor / best 1-reactor {best[4] / best[1]:.3f}")
    dev, k1 = native_device_rpc(torch, kernels, device, scale)
    out["device_rpc"] = dev
    fmt = lambda vals: " / ".join(f"{v:.1f}" for v in vals)  # noqa: E731
    for name in NATIVE_RPC_CONFIGS:
        prof = dev["profile"].get(name, {}).get("idle_pct")
        burst = (f"; 16 x 8 {fmt(dev['qps'][name])} calls/s (mean {fmt(dev['lat_us'][name])} us)"
                 if name in dev["qps"] else "")
        log(f"phase3f (c) device RPC (256 B, window 16), {name}: sequential "
            f"{fmt(dev['seq_us'][name])} us a call ({fmt(dev['handler_us'][name])} us inside "
            f"the handler){burst}"
            + (f", idle {prof:.2f} %" if prof is not None else ""))
    prof3b = rpc3b.get("profile", {}).get("idle_pct")
    log(f"phase3f (c) beside phase 3b's Python plane (earlier in this run): {rpc3b['rpc_seq_us']:.1f} us "
        f"a call ({rpc3b['handler_seq_us']:.1f} us inside the handler), {rpc3b['rpc_qps']:.1f} calls/s"
        + (f", idle {prof3b:.2f} %" if prof3b is not None else "")
        + f"; K1 launches by configuration: {dev['launches']}; the native plane's {dev['stats']}")
    return out, k1


# -- phase 3g: the server and channel policies on the card ----------------------

POLICY_WINDOW = 16  # the endpoint's window (phase 3b's geometry)
POLICY_FLOOD = 64  # flood callers: 4x the window
POLICY_FLOOD_PER = 40  # attempts each flood caller makes
POLICY_BACKOFF_S = 0.005  # a shed flood caller waits this long before its next attempt
POLICY_SERIAL = 150  # serial calls in the baseline, and in each third of the tail
POLICY_METHOD_LIMIT = 8  # (b)'s constant per-method limit
POLICY_NATIVE = (8, 500)  # (c)'s native flood: client threads x native_echo calls each
POLICY_LAME_DUCK = 16  # (d)'s in-flight calls when the lame duck begins
POLICY_SLOW_MS = 30.0  # (e): the FaultInjector delay of the slowed server
POLICY_BACKUP_MS = 5.0  # (e): backup_request_ms
POLICY_BACKUP_CALLS = 60  # (e): sequential calls with the backup, and as many without
POLICY_TOKEN = "phase3g-token"
# the limiter's flags for the phase: windows settle by sample count alone
# (20, no sampling gap, a window too long to time out), no probe-down inside
# the run, and the qps ceiling's EMA keeps half of each window so the limit
# settles within a few windows of the load changing
POLICY_FLAGS = dict(
    auto_cl_sampling_interval_us=0, auto_cl_min_sample_count=10, auto_cl_max_sample_count=20,
    auto_cl_sample_window_size_ms=600_000, auto_cl_initial_max_concurrency=40,
    auto_cl_noload_latency_remeasure_interval_ms=3600 * 1000,
    auto_cl_qps_alpha_factor_for_ema=0.5, auto_cl_change_rate_of_explore_ratio=0.06,
    fault_injection=True,
)


def pct(values, q):
    """The q-quantile (0..1) of ``values`` by rank, None when empty."""
    if not values:
        return None
    v = sorted(values)
    return v[min(len(v) - 1, int(len(v) * q))]


class Gate:
    """A one-shot gate for holding calls inside a handler. Its waiters park
    in a butex wait, so a worker of the port's pool held here counts as
    blocked and the pool grows past it, as it does past a handler waiting
    on the card (a ``threading.Event`` would hold the worker unseen, and
    the next request would queue behind the held ones)."""

    def __init__(self):
        from incubator_brpc_tpu_torch.runtime.butex import Butex

        self._butex = Butex(0)

    def wait(self, timeout: float = 60.0) -> bool:
        deadline = time.monotonic() + timeout
        while self._butex.load() == 0:
            left = deadline - time.monotonic()
            if left <= 0:
                return False
            self._butex.wait(0, timeout=left)
        return True

    def set(self) -> None:
        self._butex.add(1)
        self._butex.wake_all()


class PolicyCalls:
    """Device-echo calls of 256 B through one Channel, every admitted reply
    held against ``expected(words, 0)``; the codes of the rest counted."""

    def __init__(self, seed: int, nbytes: int = 256):
        self.rng = np.random.default_rng(seed)
        self.nbytes = nbytes
        self.lock = threading.Lock()
        self.codes = {}
        self.ok = 0

    def one(self, ch):
        from incubator_brpc_tpu_torch.utils.status import ErrorCode

        with self.lock:
            p = self.rng.integers(0, 256, size=self.nbytes, dtype=np.uint8).tobytes()
        c = ch.call_method("tensor", "echo", p)
        if c.ok():
            words = np.frombuffer(p + b"\0" * (-self.nbytes % 4), np.uint32)
            if c.response_payload != expected(words, 0).tobytes()[:self.nbytes]:
                raise AssertionError("phase3g: an admitted call answered wrong bytes")
        elif c.error_code not in (ErrorCode.ELIMIT, ErrorCode.ELOGOFF, ErrorCode.ERPCAUTH):
            raise AssertionError(f"phase3g: code {c.error_code}: {c.error_text}")
        with self.lock:
            self.codes[c.error_code] = self.codes.get(c.error_code, 0) + 1
            self.ok += c.ok()
        return c


def policy_phase(torch, kernels, device=None, scale: float = 1.0):
    """Phase 3g: the server and channel policies (ROADMAP A7) around
    ``DeviceEndpoint.server_handler()`` at phase 3b's geometry (256 B,
    window 16), every admitted reply bitwise ``expected()``:
    (a) adaptive admission: ``ServerOptions(max_concurrency="auto")``, a
    serial baseline, a flood of ``POLICY_FLOOD`` callers, a serial tail in
    three thirds — the limit's trajectory, ELIMIT's count and share, the
    admitted calls' p50/p99 inside the server's handler, calls/s; (b) a
    constant per-method limit: shedding starts exactly above it; (c) the
    native plane with ``max_concurrency="auto"``: the limit seeded into
    the C++ table, moved by the telemetry drain's completions alone, a
    native-client flood of ``native_echo`` and its ELIMIT; (d) the lame
    duck: in-flight calls complete, a new one gets ELOGOFF, the drain
    thread ends; (e) a backup request over ``list://`` and ``rr`` to two
    servers, one slowed by a ``FaultInjector`` delay: wins and p50 with
    and without the backup; (f) a ``TokenAuthenticator`` on a Python-plane
    and a native-plane server and on a device link. K1 is tallied per
    part. Returns (figures, {part: K1 launches})."""
    from incubator_brpc_tpu_torch.rpc import (
        Channel, ChannelOptions, FaultInjector, Server, ServerOptions, TokenAuthenticator,
        native_echo,
    )
    from incubator_brpc_tpu_torch.transport import native_plane as np_mod
    from incubator_brpc_tpu_torch.transport.device import DeviceEndpoint
    from incubator_brpc_tpu_torch.utils import flags
    from incubator_brpc_tpu_torch.utils.status import ErrorCode

    tally = {}

    def counted(part, fn):
        before = kernels.launch_counts()
        try:
            return fn()
        finally:
            after = kernels.launch_counts()
            row = tally.setdefault(part, dict.fromkeys(K1, 0))
            for k in K1:
                row[k] += after[k] - before[k]

    saved = {name: flags.get_flag(name) for name in POLICY_FLAGS}
    for name, value in POLICY_FLAGS.items():
        flags.set_flag_unchecked(name, value)
    ep = DeviceEndpoint(window_size=POLICY_WINDOW, max_batch=POLICY_WINDOW, device=device)
    handler = ep.server_handler()
    servers = []

    def start(opts, services):
        srv = Server(opts)
        for name, hs in services.items():
            srv.add_service(name, hs)
        if not srv.start(0):
            raise AssertionError("phase3g: a Server did not start")
        servers.append(srv)
        return srv

    def channel(port, **kw):
        kw.setdefault("timeout_ms", 300_000)
        ch = Channel()
        if not ch.init(f"127.0.0.1:{port}", options=ChannelOptions(**kw)):
            raise AssertionError("phase3g: a Channel did not init")
        return ch

    def serial(ch, calls, n):
        for _ in range(n):
            calls.one(ch)

    out = {}
    n_serial = max(10, int(POLICY_SERIAL * scale))
    try:
        ep.warm(256)
        kernels.reset_launch_counts()

        # (a) adaptive admission under a flood ---------------------------
        spans = {"baseline": [], "flood": [], "tail": []}
        stage = {"now": "baseline"}

        def timed(cntl, request):
            t0 = time.perf_counter()
            try:
                return handler(cntl, request)
            finally:
                spans[stage["now"]].append(time.perf_counter() - t0)

        srv = start(ServerOptions(max_concurrency="auto", device=device), {"tensor": {"echo": timed}})
        lim = srv._server_limiter
        t_start = time.perf_counter()
        trajectory = [(0.0, srv.max_concurrency)]
        forward = lim._on_limit_change

        def record(new_limit):
            trajectory.append((time.perf_counter() - t_start, new_limit))
            forward(new_limit)

        lim._on_limit_change = record
        ch = channel(srv.port, max_retry=0)
        a = {}
        base = PolicyCalls(41)
        counted("a", lambda: serial(ch, base, n_serial))
        if base.codes.get(ErrorCode.ELIMIT):
            raise AssertionError(f"phase3g (a): ELIMIT in the serial baseline: {base.codes}")
        a["limit_after_baseline"] = srv.max_concurrency
        stage["now"] = "flood"
        flood = PolicyCalls(42)
        per = max(4, int(POLICY_FLOOD_PER * scale))
        t_flood = time.perf_counter()

        def flooder(i):
            for _ in range(per):
                if flood.one(ch).error_code == ErrorCode.ELIMIT:
                    time.sleep(POLICY_BACKOFF_S)

        counted("a", lambda: call_threads(POLICY_FLOOD, flooder))
        flood_s = time.perf_counter() - t_flood
        flood_limits = [v for t, v in trajectory if t_flood - t_start <= t <= t_flood - t_start + flood_s]
        a["limit_after_flood"] = srv.max_concurrency
        stage["now"] = "tail"
        tail_limits = []
        tail = PolicyCalls(43)
        for _ in range(3):
            counted("a", lambda: serial(ch, tail, n_serial))
            tail_limits.append(srv.max_concurrency)
        shed = flood.codes.get(ErrorCode.ELIMIT, 0)
        attempts = POLICY_FLOOD * per
        if not shed:
            raise AssertionError(f"phase3g (a): the flood was never shed: {flood.codes}, "
                                 f"limit {srv.max_concurrency}")
        if flood.ok + shed != attempts or tail.ok != 3 * n_serial:
            raise AssertionError(f"phase3g (a): flood {flood.codes}, tail {tail.codes}")
        flood_max = max(flood_limits + [a["limit_after_baseline"]])
        # settled: the tail's last two thirds end within a step of each
        # other (one, or a quarter of the limit)
        if abs(tail_limits[2] - tail_limits[1]) > max(1, tail_limits[1] // 4):
            raise AssertionError(f"phase3g (a): the limit did not settle after the flood: tail "
                                 f"thirds {tail_limits}, flood max {flood_max}")
        a.update(
            flood_callers=POLICY_FLOOD, attempts=attempts, admitted=flood.ok, elimit=shed,
            elimit_share=shed / attempts, flood_s=flood_s, admitted_per_s=flood.ok / flood_s,
            attempts_per_s=attempts / flood_s, flood_limit_max=flood_max,
            flood_limit_min=min(flood_limits) if flood_limits else a["limit_after_baseline"],
            tail_limits=tail_limits, limit_moves=len(trajectory) - 1,
            trajectory=[(round(t, 4), v) for t, v in trajectory],
            baseline_p50_us=1e6 * pct(spans["baseline"], 0.5),
            baseline_p99_us=1e6 * pct(spans["baseline"], 0.99),
            flood_p50_us=1e6 * pct(spans["flood"], 0.5), flood_p99_us=1e6 * pct(spans["flood"], 0.99),
            tail_p50_us=1e6 * pct(spans["tail"], 0.5), limiter=lim.describe(),
        )
        out["a"] = a
        log(f"phase3g (a) adaptive admission (max_concurrency='auto', window {POLICY_WINDOW}): the "
            f"limit {trajectory[0][1]} -> {a['limit_after_baseline']} after {n_serial} serial "
            f"calls; flood of {POLICY_FLOOD} callers x {per}: {shed} of {attempts} shed with "
            f"ELIMIT ({100 * a['elimit_share']:.1f} %), {flood.ok} admitted in {flood_s:.2f} s "
            f"({a['admitted_per_s']:.1f} admitted calls/s, {a['attempts_per_s']:.1f} attempts/s), the "
            f"limit between {a['flood_limit_min']} and {flood_max} ({a['limit_moves']} moves in all), "
            f"{a['limit_after_flood']} at its end; inside the handler p50/p99 "
            f"{a['baseline_p50_us']:.1f}/{a['baseline_p99_us']:.1f} us serial, "
            f"{a['flood_p50_us']:.1f}/{a['flood_p99_us']:.1f} us admitted in the flood; the serial "
            f"tail's limit by thirds {tail_limits} (p50 {a['tail_p50_us']:.1f} us); launches "
            f"{[tally['a'][k] for k in K1]}")
        srv.stop()
        srv.join(timeout=60)

        # (b) a constant per-method limit --------------------------------
        gate = Gate()
        entered = []
        entered_lock = threading.Lock()

        def gated(cntl, request):
            with entered_lock:
                entered.append(1)
            if not gate.wait(120):
                raise AssertionError("phase3g (b): the gate was never opened")
            return handler(cntl, request)

        srv = start(ServerOptions(method_max_concurrency=POLICY_METHOD_LIMIT, device=device),
                    {"tensor": {"echo": gated}})
        ch = channel(srv.port, max_retry=0)
        held = PolicyCalls(44)
        b = {"limit": srv.method_max_concurrency("tensor.echo")}

        def run_b():
            threads = [threading.Thread(target=held.one, args=(ch,))
                       for _ in range(POLICY_METHOD_LIMIT)]
            for i, t in enumerate(threads):
                t.start()
                deadline = time.monotonic() + 60
                while len(entered) < i + 1 and time.monotonic() < deadline:
                    time.sleep(0.001)
                if len(entered) != i + 1:
                    raise AssertionError(f"phase3g (b): call {i + 1} of {POLICY_METHOD_LIMIT} was "
                                         f"not admitted ({held.codes})")
            over = held.one(ch)
            b["over_limit_code"] = over.error_code
            gate.set()
            for t in threads:
                t.join(120)

        counted("b", run_b)
        if b["over_limit_code"] != ErrorCode.ELIMIT or held.ok != POLICY_METHOD_LIMIT:
            raise AssertionError(f"phase3g (b): {POLICY_METHOD_LIMIT} held, then code "
                                 f"{b['over_limit_code']}; {held.codes}")
        out["b"] = b
        log(f"phase3g (b) method_max_concurrency={POLICY_METHOD_LIMIT}: calls 1-{POLICY_METHOD_LIMIT} "
            f"held in the handler were admitted, call {POLICY_METHOD_LIMIT + 1} got ELIMIT; the "
            f"{POLICY_METHOD_LIMIT} then answered bitwise expected(); launches "
            f"{[tally['b'][k] for k in K1]}")
        srv.stop()
        srv.join(timeout=60)

        # (c) the native plane with an adaptive limit --------------------
        srv = start(ServerOptions(native_plane=True, max_concurrency="auto", device=device),
                    {"host": {"echo": native_echo}, "tensor": {"echo": handler}})
        plane = srv._native_plane
        if plane is None or "host.echo" not in plane.native_method_names():
            raise AssertionError("phase3g (c): host.echo is not on the C++ dispatch")
        c = {"seeded": plane.native_max_concurrency("host.echo"), "initial": srv.max_concurrency}
        if c["seeded"] != c["initial"]:
            raise AssertionError(f"phase3g (c): the C++ table holds {c['seeded']}, the limiter "
                                 f"{c['initial']}")
        before = srv._server_limiter.describe()
        codes = {}
        codes_lock = threading.Lock()
        nthreads, ncalls = POLICY_NATIVE
        ncalls = max(50, int(ncalls * scale))

        def native_flood(i):
            nch = np_mod.NativeClientChannel("127.0.0.1", srv.port)
            try:
                for _ in range(ncalls):
                    rc, err, _meta, body = nch.call("host", "echo", b"x" * 64, timeout_ms=60_000)
                    if rc < 0 or (err == 0 and len(body) != 64):
                        raise AssertionError(f"phase3g (c): native call rc {rc} err {err}")
                    with codes_lock:
                        codes[err] = codes.get(err, 0) + 1
            finally:
                nch.close()

        t0 = time.perf_counter()
        call_threads(nthreads, native_flood)
        c["native_s"] = time.perf_counter() - t0
        plane.drain_telemetry()
        after = srv._server_limiter.describe()
        c.update(native_calls=nthreads * ncalls, native_codes={str(k): v for k, v in codes.items()},
                 elimit=codes.get(ErrorCode.ELIMIT, 0), limit_after=srv.max_concurrency,
                 table_after=plane.native_max_concurrency("host.echo"),
                 min_latency_us=after["min_latency_us"], ema_max_qps=after["ema_max_qps"],
                 drained=plane._tel_drained)
        if set(codes) - {0, ErrorCode.ELIMIT}:
            raise AssertionError(f"phase3g (c): native codes {codes}")
        if not (before["min_latency_us"] <= 0 < after["min_latency_us"]
                and c["limit_after"] != c["initial"] and c["table_after"] == c["limit_after"]):
            raise AssertionError(f"phase3g (c): the telemetry drain did not move the limit into the "
                                 f"C++ table: {before} -> {after}, table {c['table_after']}")
        dch = channel(srv.port, max_retry=0)
        via_python = PolicyCalls(45)
        counted("c", lambda: serial(dch, via_python, 20))
        if via_python.ok != 20:
            raise AssertionError(f"phase3g (c): device calls on the Python route {via_python.codes}")
        out["c"] = c
        log(f"phase3g (c) native plane, max_concurrency='auto': seeded {c['seeded']} in the C++ "
            f"table; {c['native_calls']} native_echo calls ({nthreads} native clients) in "
            f"{c['native_s']:.2f} s, {c['elimit']} answered ELIMIT by the C++ dispatch; the "
            f"telemetry drain alone ({c['drained']} records) moved the limit to {c['limit_after']} "
            f"(min latency {c['min_latency_us']:.1f} us, qps ceiling {c['ema_max_qps']:.0f}), the "
            f"C++ table {c['table_after']}; 20 device calls on the Python route answered; launches "
            f"{[tally['c'][k] for k in K1]}")
        srv.stop()
        srv.join(timeout=60)

        # (d) the lame duck -----------------------------------------------
        gate = Gate()
        entered.clear()
        srv = start(ServerOptions(device=device), {"tensor": {"echo": gated}})
        ch = channel(srv.port, max_retry=0)
        inflight = PolicyCalls(46)
        d = {}

        def run_d():
            threads = [threading.Thread(target=inflight.one, args=(ch,))
                       for _ in range(POLICY_LAME_DUCK)]
            for t in threads:
                t.start()
            deadline = time.monotonic() + 60
            while srv._nprocessing < POLICY_LAME_DUCK and time.monotonic() < deadline:
                time.sleep(0.001)
            if srv._nprocessing != POLICY_LAME_DUCK:
                raise AssertionError(f"phase3g (d): {srv._nprocessing} in flight")
            t_enter = time.perf_counter()
            drain = srv.enter_lame_duck(grace_s=120)
            late = inflight.one(ch)
            d["new_call_code"] = late.error_code
            t_release = time.perf_counter()
            gate.set()
            for t in threads:
                t.join(120)
            drain.join(120)
            t_end = time.perf_counter()
            d.update(drain_alive=drain.is_alive(), drain_s=t_end - t_enter,
                     release_to_end_s=t_end - t_release, stopped=srv._stopping)

        counted("d", run_d)
        if (d["new_call_code"] != ErrorCode.ELOGOFF or inflight.ok != POLICY_LAME_DUCK
                or d["drain_alive"] or not d["stopped"]):
            raise AssertionError(f"phase3g (d): {d}, codes {inflight.codes}")
        out["d"] = d
        log(f"phase3g (d) lame duck with {POLICY_LAME_DUCK} device calls in flight: every one "
            f"answered code 0 bitwise expected(), a new call got ELOGOFF, the drain thread ended "
            f"{d['release_to_end_s'] * 1e3:.1f} ms after the calls were let go "
            f"({d['drain_s'] * 1e3:.1f} ms from enter_lame_duck, the 250 ms linger included) and "
            f"stopped the server; launches {[tally['d'][k] for k in K1]}")

        # (e) a backup request -------------------------------------------
        def tagged(tag):
            def run(cntl, request):
                cntl.response_attachment = tag
                return handler(cntl, request)
            return run

        slow = start(ServerOptions(fault_injector=FaultInjector(delay_rate=1.0,
                                                                delay_ms=POLICY_SLOW_MS),
                                   device=device), {"tensor": {"echo": tagged(b"slow")}})
        fast = start(ServerOptions(device=device), {"tensor": {"echo": tagged(b"fast")}})
        url = f"list://127.0.0.1:{slow.port},127.0.0.1:{fast.port}"
        e = {}
        n_backup = max(10, int(POLICY_BACKUP_CALLS * scale))

        def lb_run(backup_ms, seed):
            ch = Channel()
            if not ch.init(url, "rr", ChannelOptions(timeout_ms=300_000, max_retry=1,
                                                     backup_request_ms=backup_ms)):
                raise AssertionError("phase3g (e): the LB channel did not init")
            calls = PolicyCalls(seed)
            lat, wins, fired = [], 0, 0
            for _ in range(n_backup):
                t0 = time.perf_counter()
                cn = calls.one(ch)
                lat.append(time.perf_counter() - t0)
                if not cn.ok():
                    raise AssertionError(f"phase3g (e): code {cn.error_code}")
                fired += cn.has_backup_request
                # the backup went to the last server the call was sent to;
                # it won when that server's tag came back
                backup_to = cn._sent_sockets[-1].remote.port if cn._sent_sockets else None
                tag = {slow.port: b"slow", fast.port: b"fast"}.get(backup_to)
                wins += cn.has_backup_request and cn.response_attachment == tag
            ch._lb.stop()
            return lat, wins, fired

        lat_plain, _, _ = counted("e", lambda: lb_run(-1, 47))
        lat_backup, wins, fired = counted("e", lambda: lb_run(POLICY_BACKUP_MS, 48))
        e.update(calls=n_backup, slow_ms=POLICY_SLOW_MS, backup_ms=POLICY_BACKUP_MS,
                 backups_fired=fired, backup_wins=wins,
                 p50_without_us=1e6 * pct(lat_plain, 0.5), p50_with_us=1e6 * pct(lat_backup, 0.5),
                 p99_without_us=1e6 * pct(lat_plain, 0.99), p99_with_us=1e6 * pct(lat_backup, 0.99),
                 slow_delays=slow.fault_injector.injected["delay"])
        out["e"] = e
        log(f"phase3g (e) backup request over list:// rr, one server slowed {POLICY_SLOW_MS:.0f} ms "
            f"by a FaultInjector, backup_request_ms={POLICY_BACKUP_MS:g}: {n_backup} calls each way, "
            f"every reply bitwise expected(); the backup fired {fired} times and won {wins}; p50 "
            f"{e['p50_without_us']:.1f} us without the backup, {e['p50_with_us']:.1f} us with it "
            f"(p99 {e['p99_without_us']:.1f} / {e['p99_with_us']:.1f} us); launches "
            f"{[tally['e'][k] for k in K1]}")
        for s in (slow, fast):
            s.stop()
            s.join(timeout=60)

        # (f) auth --------------------------------------------------------
        f = {}
        py_srv = start(ServerOptions(auth=TokenAuthenticator([POLICY_TOKEN]), device=device),
                       {"tensor": {"echo": handler}})
        nat_srv = start(ServerOptions(native_plane=True, auth=TokenAuthenticator([POLICY_TOKEN]),
                                      device=device), {"tensor": {"echo": handler}})
        auth_calls = PolicyCalls(49)

        def run_f():
            for label, s in (("python_plane", py_srv), ("native_plane", nat_srv)):
                good = channel(s.port, auth=TokenAuthenticator(POLICY_TOKEN))
                ok_before = auth_calls.ok
                serial(good, auth_calls, 10)
                row = {"right": auth_calls.ok - ok_before}
                row["wrong"] = auth_calls.one(channel(s.port, auth=TokenAuthenticator("nope"))).error_code
                row["missing"] = auth_calls.one(channel(s.port)).error_code
                if label == "native_plane":
                    row["native_client_missing"] = auth_calls.one(
                        channel(s.port, native_plane=True)).error_code
                    row["native_reqs"] = s._native_plane.stats()["native_reqs"]
                f[label] = row
            link = channel(py_srv.port, transport="tpu", auth=TokenAuthenticator(POLICY_TOKEN))
            ok_before = auth_calls.ok
            serial(link, auth_calls, 10)
            f["link"] = {"right": auth_calls.ok - ok_before,
                         "linked": link._device_sock is not None}
            bare = channel(py_srv.port, transport="tpu", max_retry=0)
            refused = bare.call_method("tensor", "echo", b"\0" * 256)
            f["link"]["bare_code"] = refused.error_code
            f["link"]["bare_text"] = refused.error_text

        counted("f", run_f)
        for label in ("python_plane", "native_plane"):
            row = f[label]
            bad = [k for k in ("wrong", "missing", "native_client_missing")
                   if k in row and row[k] != ErrorCode.ERPCAUTH]
            if row["right"] != 10 or bad:
                raise AssertionError(f"phase3g (f) {label}: {row}")
        if f["link"]["right"] != 10 or not f["link"]["linked"] or f["link"]["bare_code"] == 0:
            raise AssertionError(f"phase3g (f) the device link: {f['link']}")
        out["f"] = f
        log(f"phase3g (f) TokenAuthenticator: the right token answered 10 of 10 device calls on "
            f"the Python plane and on the native plane (native requests there "
            f"{f['native_plane']['native_reqs']}: tensor.echo is a Python method), a wrong or "
            f"missing one got ERPCAUTH ({f['python_plane']['wrong']}, "
            f"{f['native_plane']['missing']}, the native client's "
            f"{f['native_plane']['native_client_missing']}); a device link with the token "
            f"handshook and answered 10 of 10, one without it was refused (code "
            f"{f['link']['bare_code']}: {f['link']['bare_text']}); launches "
            f"{[tally['f'][k] for k in K1]}")
    finally:
        for s in servers:
            s.stop()
            s.join(timeout=60)
        for name, value in saved.items():
            flags.set_flag_unchecked(name, value)
        if not ep.close(timeout=120):
            raise AssertionError("phase3g: the endpoint did not settle its calls")
    return out, tally


# -- phase 3h: baidu_std, HTTP and json2pb around the device echo ---------------

PROTO_WINDOW = 16  # the endpoint's window (phase 3b's geometry)
PROTO_SEQ = 20  # sequential calls a client
PROTO_BURST = (16, 8)  # callers x calls each
PROTO_TURNS = 2  # (a) and (b) run in turns, this many times each
PRPC_PAYLOAD = (b"The quick brown fox jumps over the lazy dog. " * 92)[:4096]
PRPC_PUMP = (20000, 128, 3)  # bench_prpc_production's pump: requests, in flight, runs
PRPC_ECHO = (500, 300)  # its rpc_echo_prpc_snappy_us and _python_us calls a run
PRPC_TOKEN = "phase3h-token"


def echo_check(label, payload, code, out, phase="phase3h"):
    """Hold one device echo of ``payload`` against ``expected(words, 0)``."""
    if code != 0:
        raise AssertionError(f"{phase} {label}: code {code}")
    nbytes = len(payload)
    words = np.frombuffer(payload + b"\0" * (-nbytes % 4), np.uint32)
    if out != expected(words, 0).tobytes()[:nbytes]:
        raise AssertionError(f"{phase} {label}: an echo answered wrong bytes")


def echo_runs(label, call, rng, n_seq, burst):
    """``n_seq`` sequential echoes of 256 B and a ``burst`` (callers, calls
    each) through ``call(payload) -> (code, bytes)``, every answer held
    against ``expected()``. Returns (µs a sequential call, calls/s)."""
    seq = [rng.integers(0, 256, size=256, dtype=np.uint8).tobytes() for _ in range(n_seq)]
    it = iter(seq)

    def one():
        p = next(it)
        echo_check(label, p, *call(p))

    seq_us = sequential_us(one, n_seq)
    n_threads, per = burst
    payloads = [[rng.integers(0, 256, size=256, dtype=np.uint8).tobytes() for _ in range(per)]
                for _ in range(n_threads)]

    def caller(i):
        for p in payloads[i]:
            echo_check(label, p, *call(p))

    t0 = time.perf_counter()
    call_threads(n_threads, caller)
    return seq_us, n_threads * per / (time.perf_counter() - t0)


class KeepAliveHttp:
    """A curl-like HTTP/1.1 client on one keep-alive connection: POST with a
    body of the given content type, the response read by Content-Length."""

    def __init__(self, port: int):
        import socket

        self.sock = socket.create_connection(("127.0.0.1", port), timeout=300)
        self.lock = threading.Lock()

    def post(self, path: str, body: bytes, ctype: str = "application/octet-stream"):
        head = (f"POST {path} HTTP/1.1\r\nHost: 127.0.0.1\r\nContent-Type: {ctype}\r\n"
                f"Content-Length: {len(body)}\r\nConnection: keep-alive\r\n\r\n").encode("latin-1")
        with self.lock:
            self.sock.sendall(head + body)
            raw = b""
            while b"\r\n\r\n" not in raw:
                data = self.sock.recv(65536)
                if not data:
                    raise AssertionError("phase3h (d): the gateway closed the connection")
                raw += data
            head_end = raw.index(b"\r\n\r\n")
            lines = raw[:head_end].decode("latin-1").split("\r\n")
            status = int(lines[0].split(" ", 2)[1])
            headers = {k.strip().lower(): v.strip()
                       for k, _, v in (line.partition(":") for line in lines[1:])}
            size = int(headers.get("content-length", "0"))
            rest = raw[head_end + 4:]
            while len(rest) < size:
                data = self.sock.recv(65536)
                if not data:
                    raise AssertionError("phase3h (d): the gateway closed mid-body")
                rest += data
            return status, headers, rest[:size]

    def close(self):
        self.sock.close()


def protocol_phase(torch, kernels, device=None, scale: float = 1.0):
    """Phase 3h: the device echo (``DeviceEndpoint.server_handler()`` as
    ``tensor.echo``, 256 B, window 16) over the wires of ROADMAP A11a,
    every answer bitwise ``expected()``: (a) baidu_std on the Python plane,
    sequential µs and calls/s at 16 x 8; (b) baidu_std behind the native
    plane from the Python ``Channel`` and from ``NativeClientChannel``, in
    turns with (a); (c) ``bench_prpc_production``'s rows on the native
    plane (pumps of 4 KiB plain, snappy over compressible and over random
    bytes, and token-authenticated; every flood kept off the interpreter,
    ``cb_frames == 0``) and the snappy echo through the channel, natively
    and on the pure-Python plane; (d) the HTTP gateway (``POST
    /tensor/echo``, octet-stream, keep-alive), ``ChannelOptions(protocol=
    "http")``, and a json2pb typed service over the echo answering a
    curl-style JSON POST, checked field by field. K1 is tallied per part.
    Returns (figures, {part: K1 launches})."""
    import base64

    from incubator_brpc_tpu_torch.protocol import compress as compress_mod
    from incubator_brpc_tpu_torch.protocol.json2pb import Message, field, typed_handler
    from incubator_brpc_tpu_torch.rpc import (
        Channel, ChannelOptions, Controller, Server, ServerOptions, TokenAuthenticator,
        native_echo,
    )
    from incubator_brpc_tpu_torch.transport import native_plane as np_mod
    from incubator_brpc_tpu_torch.transport.device import DeviceEndpoint

    tally = {}

    def counted(part, fn):
        before = kernels.launch_counts()
        try:
            return fn()
        finally:
            after = kernels.launch_counts()
            row = tally.setdefault(part, dict.fromkeys(K1, 0))
            for k in K1:
                row[k] += after[k] - before[k]

    class EchoRequest(Message):
        tag = field(1, str)
        seq = field(2, int)
        data = field(3, bytes)

    class EchoResponse(Message):
        tag = field(1, str)
        seq = field(2, int)
        data = field(3, bytes)
        words = field(4, int)

    ep = DeviceEndpoint(window_size=PROTO_WINDOW, max_batch=PROTO_WINDOW, device=device)
    handler = ep.server_handler()

    def typed_echo(cntl, req):
        code, out = ep.call_bytes(req.data, timeout=300)
        if code != 0:
            raise RuntimeError(f"device echo code {code}")
        return EchoResponse(tag=req.tag, seq=req.seq + 1, data=out, words=len(out) // 4)

    echo_services = {"tensor": {"echo": handler},
                     "typed": {"echo": typed_handler(EchoRequest, EchoResponse, typed_echo)}}
    bench_services = {"bench": {"echo": native_echo}}
    servers = []

    def start(services, **kw):
        srv = Server(ServerOptions(device=device, **kw))
        for name, hs in services.items():
            srv.add_service(name, hs)
        if not srv.start(0):
            raise AssertionError("phase3h: a Server did not start")
        servers.append(srv)
        return srv

    def channel(port, **kw):
        ch = Channel()
        if not ch.init(f"127.0.0.1:{port}", options=ChannelOptions(timeout_ms=300_000, **kw)):
            raise AssertionError("phase3h: a Channel did not init")
        return ch

    def via_channel(ch):
        def call(p):
            c = ch.call_method("tensor", "echo", p)
            return c.error_code, c.response_payload
        return call

    def on_client(label, ch, native_calls, fn):
        """Run ``fn`` and hold that its calls took the client the row names:
        ``native_calls`` calls of the native client (0: none), and a
        ``Channel`` ``ch`` holding its native connection exactly when they
        ride it (a Channel falls through to the Python client quietly)."""
        before = (np_mod.native_client_calls.get_value(), np_mod.native_client_errors.get_value())
        r = fn()
        got = np_mod.native_client_calls.get_value() - before[0]
        errors = np_mod.native_client_errors.get_value() - before[1]
        if (got, errors) != (native_calls, 0) or (
                ch is not None and (ch._native_ch is not None) != (native_calls > 0)):
            raise AssertionError(f"phase3h {label}: {got} native client calls ({errors} failed), "
                                 f"{native_calls} expected; the call took the wrong client")
        return r

    n_seq = max(4, int(PROTO_SEQ * scale))
    burst = (PROTO_BURST[0], max(1, int(PROTO_BURST[1] * scale)))
    rng = np.random.default_rng(53)
    out = {}
    try:
        ep.warm(256)
        py_srv = start(echo_services)
        nat_srv = start(echo_services, native_plane=True)

        # (a) and (b), in turns ------------------------------------------
        a, b_ch, b_nat = [], [], []
        nch = np_mod.NativeClientChannel("127.0.0.1", nat_srv.port, protocol="baidu_std")

        def native_call(p):
            rc, code, meta, body = nch.call("tensor", "echo", p, timeout_ms=300_000)
            if rc < 0:
                raise AssertionError(f"phase3h (b): native client transport errno {-rc}")
            return code, body.to_bytes()

        py_ch = channel(py_srv.port, protocol="baidu_std")
        nat_ch = channel(nat_srv.port, protocol="baidu_std", native_plane=True)
        n_calls = n_seq + burst[0] * burst[1]
        for _ in range(PROTO_TURNS):
            a.append(counted("a", lambda: on_client(
                "(a)", py_ch, 0, lambda: echo_runs("(a)", via_channel(py_ch), rng, n_seq, burst))))
            b_ch.append(counted("b", lambda: on_client(
                "(b) Channel", nat_ch, n_calls,
                lambda: echo_runs("(b) Channel", via_channel(nat_ch), rng, n_seq, burst))))
            b_nat.append(counted("b", lambda: on_client(
                "(b) NativeClientChannel", None, n_calls,
                lambda: echo_runs("(b) NativeClientChannel", native_call, rng, n_seq, burst))))
        nch.close()
        st = nat_srv._native_plane.stats()
        out["a"] = {"seq_us": [r[0] for r in a], "calls_per_s": [r[1] for r in a]}
        out["b"] = {"channel_seq_us": [r[0] for r in b_ch], "channel_calls_per_s": [r[1] for r in b_ch],
                    "native_seq_us": [r[0] for r in b_nat], "native_calls_per_s": [r[1] for r in b_nat],
                    "cb_frames": st["cb_frames"]}
        if st["cb_frames"] < 2 * PROTO_TURNS * (n_seq + burst[0] * burst[1]):
            raise AssertionError(f"phase3h (b): the device echo did not reach the Python route "
                                 f"behind the native plane: {st}")
        log(f"phase3h (a) baidu_std on the Python plane, device echo 256 B, window "
            f"{PROTO_WINDOW}: {', '.join(f'{r[0]:.1f}' for r in a)} us a sequential call, "
            f"{', '.join(f'{r[1]:.1f}' for r in a)} calls/s at {burst[0]} x {burst[1]} (turns); "
            f"launches {[tally['a'][k] for k in K1]}")
        log(f"phase3h (b) baidu_std behind the native plane: Channel(native_plane=True) "
            f"{', '.join(f'{r[0]:.1f}' for r in b_ch)} us a call, "
            f"{', '.join(f'{r[1]:.1f}' for r in b_ch)} calls/s; NativeClientChannel "
            f"{', '.join(f'{r[0]:.1f}' for r in b_nat)} us a call, "
            f"{', '.join(f'{r[1]:.1f}' for r in b_nat)} calls/s (turns with (a)); frames on the "
            f"Python route {st['cb_frames']}; launches {[tally['b'][k] for k in K1]}")

        # (c) bench_prpc_production's rows ---------------------------------
        c = {}
        n_pump, inflight, runs = max(500, int(PRPC_PUMP[0] * scale)), PRPC_PUMP[1], PRPC_PUMP[2]
        random_4k = rng.integers(0, 256, size=4096, dtype=np.uint8).tobytes()

        def pump_row(name, srv, data, compress="", auth=""):
            pch = np_mod.NativeClientChannel("127.0.0.1", srv.port, protocol="baidu_std")
            try:
                if auth:
                    pch.set_auth(auth)
                wire = data
                if compress:
                    pch.set_request_compress(compress)
                    wire = compress_mod.compress(compress, data)
                pch.pump("bench", "echo", wire, max(200, n_pump // 10), inflight=64)  # warm
                c[name] = [pch.pump("bench", "echo", wire, n_pump, inflight=inflight)
                           for _ in range(runs)]
            finally:
                pch.close()
            cb = srv._native_plane.stats()["cb_frames"]
            if cb != 0:
                raise AssertionError(f"phase3h (c) {name}: {cb} frames reached the interpreter")

        def echo_row(name, port, opts, n):
            ch = Channel()
            if not ch.init(f"127.0.0.1:{port}", options=opts):
                raise AssertionError("phase3h (c): a Channel did not init")
            lat = []
            for rep in range(4):  # the first a warm-up
                calls = n if rep else max(10, n // 10)

                def run():
                    for _ in range(calls):
                        cntl = Controller()
                        cntl.compress_type = "snappy"
                        r = ch.call_method("bench", "echo", PRPC_PAYLOAD, cntl=cntl)
                        if not r.ok() or r.response_payload != PRPC_PAYLOAD:
                            raise AssertionError(
                                f"phase3h (c) {name}: code {r.error_code} {r.error_text}")

                t0 = time.perf_counter()
                on_client(f"(c) {name}", ch, calls if opts.native_plane else 0, run)
                if rep:
                    lat.append((time.perf_counter() - t0) / n * 1e6)
            c[name] = lat

        bare = start(bench_services, native_plane=True, native_loops=1, usercode_inline=True)
        counted("c", lambda: pump_row("prpc_plain_4k_pump_ns", bare, PRPC_PAYLOAD))
        token_srv = start(bench_services, native_plane=True, native_loops=1, usercode_inline=True,
                          auth=TokenAuthenticator([PRPC_TOKEN]))

        def run_c():
            pump_row("prpc_compressed_pump_ns", token_srv, PRPC_PAYLOAD, "snappy", PRPC_TOKEN)
            pump_row("prpc_compressed_incompressible_pump_ns", token_srv, random_4k, "snappy",
                     PRPC_TOKEN)
            pump_row("prpc_auth_pump_ns", token_srv, PRPC_PAYLOAD, auth=PRPC_TOKEN)
            echo_row("rpc_echo_prpc_snappy_us", token_srv.port,
                     ChannelOptions(native_plane=True, protocol="baidu_std",
                                    auth=TokenAuthenticator([PRPC_TOKEN])),
                     max(20, int(PRPC_ECHO[0] * scale)))
            py_token = start(bench_services, usercode_inline=True,
                             auth=TokenAuthenticator([PRPC_TOKEN]))
            echo_row("rpc_echo_prpc_snappy_python_us", py_token.port,
                     ChannelOptions(protocol="baidu_std", auth=TokenAuthenticator([PRPC_TOKEN])),
                     max(20, int(PRPC_ECHO[1] * scale)))

        counted("c", run_c)
        cs = token_srv._native_plane.compress_stats()
        if not (cs["in_raw"] > cs["in_wire"] > 0 and cs["out_raw"] > cs["out_wire"] > 0):
            raise AssertionError(f"phase3h (c): the native codec did not run: {cs}")
        c["compress_stats"] = cs
        c["compressed_vs_plain_ratio"] = min(c["prpc_compressed_pump_ns"]) / min(c["prpc_plain_4k_pump_ns"])
        c["snappy_python_vs_native"] = (min(c["rpc_echo_prpc_snappy_python_us"])
                                        / min(c["rpc_echo_prpc_snappy_us"]))
        out["c"] = c
        log(f"phase3h (c) bench_prpc_production on the native plane (1 reactor; pumps of {n_pump} "
            f"requests at {inflight} in flight, {runs} runs, ns a request): plain 4 KiB "
            f"{c['prpc_plain_4k_pump_ns']}, snappy compressible {c['prpc_compressed_pump_ns']}, "
            f"snappy random {c['prpc_compressed_incompressible_pump_ns']}, token auth "
            f"{c['prpc_auth_pump_ns']} (cb_frames 0 after every flood; codec bytes {cs}); the "
            f"snappy+token echo of 4 KiB through the Channel: native plane "
            f"{', '.join(f'{v:.1f}' for v in c['rpc_echo_prpc_snappy_us'])} us, the pure-Python "
            f"plane {', '.join(f'{v:.1f}' for v in c['rpc_echo_prpc_snappy_python_us'])} us "
            f"({c['snappy_python_vs_native']:.2f}x)")

        # (d) HTTP: the gateway, the http channel, json2pb ------------------
        d = {}
        gw = KeepAliveHttp(py_srv.port)

        def gateway_call(p):
            status, headers, body = gw.post("/tensor/echo", p)
            if status != 200 or headers.get("content-type") != "application/octet-stream":
                raise AssertionError(f"phase3h (d) gateway: HTTP {status} {body[:200]!r}")
            return 0, body

        d["gateway_seq_us"], d["gateway_calls_per_s"] = counted(
            "d", lambda: echo_runs("(d) gateway", gateway_call, rng, n_seq, (1, n_seq)))
        http_ch = channel(py_srv.port, protocol="http")
        d["channel_seq_us"], d["channel_calls_per_s"] = counted(
            "d", lambda: echo_runs("(d) http channel", via_channel(http_ch), rng, n_seq, burst))
        # a handed-off HTTP connection on the native plane's port
        nat_http = channel(nat_srv.port, protocol="http")
        d["native_port_seq_us"], _ = counted(
            "d", lambda: echo_runs("(d) http on the native port", via_channel(nat_http), rng,
                                   n_seq, (1, 1)))
        data = rng.integers(0, 256, size=256, dtype=np.uint8).tobytes()
        req = json.dumps({"tag": "phase3h", "seq": 41,
                          "data": base64.b64encode(data).decode()}).encode()

        def typed_call():
            return gw.post("/typed/echo", req, ctype="application/json")

        status, headers, body = counted("d", typed_call)
        gw.close()
        if status != 200 or headers.get("content-type") != "application/json":
            raise AssertionError(f"phase3h (d) json2pb: HTTP {status} {body[:200]!r}")
        got = json.loads(body)
        echoed = base64.b64decode(got["data"])
        echo_check("(d) json2pb", data, 0, echoed)
        if (got["tag"], got["seq"], got["words"]) != ("phase3h", 42, 64) or sorted(got) != [
                "data", "seq", "tag", "words"]:
            raise AssertionError(f"phase3h (d) json2pb: fields {got}")
        d["json2pb_fields"] = sorted(got)
        out["d"] = d
        log(f"phase3h (d) HTTP: POST /tensor/echo (octet-stream, keep-alive) "
            f"{d['gateway_seq_us']:.1f} us a call; ChannelOptions(protocol='http') "
            f"{d['channel_seq_us']:.1f} us a call, {d['channel_calls_per_s']:.1f} calls/s at "
            f"{burst[0]} x {burst[1]}; the http channel on the native plane's port (handed off) "
            f"{d['native_port_seq_us']:.1f} us a call; a json2pb typed service over the echo "
            f"answered a curl-style JSON POST, fields {d['json2pb_fields']} checked; launches "
            f"{[tally['d'][k] for k in K1]}")
    finally:
        for s in servers:
            s.stop()
            s.join(timeout=60)
        if not ep.close(timeout=120):
            raise AssertionError("phase3h: the endpoint did not settle its calls")
    return out, tally


# -- phase 3i: rpcz spans, the portal and the profilers around the device echo --

RPCZ_SEQ = 40  # traced sequential device echoes on each wire
RPCZ_TURNS = 6  # span cost: turns of rpcz off and on, mirrored (off, on, on, off, ...)
RPCZ_TURN_CALLS = 200  # sequential device echoes a turn
RPCZ_BURST = (16, 8)  # callers x calls each, rpcz on: spans a second
RPCZ_SAMPLE_EVERY = 8  # native_telemetry_sample_every of the native flood
RPCZ_NATIVE_PUMP = 4096  # native_echo requests of the native flood
RPCZ_TRACE = 0x3177ACE  # the trace id (b)'s native client stamps
RPCZ_SPAN_LOOPS = 20000  # (e): a call's two spans by their code alone, this many times
RPCZ_FLAGS = dict(enable_rpcz=True, rpcz_samples_per_second=10_000_000,
                  native_telemetry_sample_every=RPCZ_SAMPLE_EVERY)
# the pages (d) scrapes over the port's own HTTP channel ("{trace}" is a
# trace of (a)); each is held to a row it must carry
RPCZ_PAGES = ("/rpcz?trace_id={trace}", "/rpcz", "/vars", "/vars.json", "/brpc_metrics", "/status",
              "/flags", "/connections", "/sockets")

# the Prometheus text exposition format v0.0.4, line by line (the JAX
# package's tests/test_observability.py validate_exposition)
_EXPO_COMMENT = re.compile(r"^# (HELP|TYPE) [a-zA-Z_:][a-zA-Z0-9_:]*( .+)?$")
_EXPO_SAMPLE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*"
    r"(\{[a-zA-Z_][a-zA-Z0-9_]*=\"([^\"\\\n]|\\\\|\\\"|\\n)*\""
    r"(,[a-zA-Z_][a-zA-Z0-9_]*=\"([^\"\\\n]|\\\\|\\\"|\\n)*\")*\})?"
    r" (-?\d+(\.\d+)?([eE][+-]?\d+)?|[+-]Inf|NaN)$"
)


def validate_exposition(text: str) -> None:
    """Every line a TYPE/HELP comment or a well-formed sample."""
    if text and not text.endswith("\n"):
        raise AssertionError("phase3i: the exposition does not end with a newline")
    for line in text.splitlines():
        if line and not (_EXPO_COMMENT.match(line) or _EXPO_SAMPLE.match(line)):
            raise AssertionError(f"phase3i: invalid exposition line {line!r}")


def contended_worker(mutex, rounds: int) -> None:
    """One of the contended FiberMutex loop's threads: hold it 2 ms a round,
    then 1 ms outside it, so the threads take turns."""
    for _ in range(rounds):
        with mutex:
            time.sleep(0.002)
        time.sleep(0.001)


def span_code_us(rpcz, Controller, Meta, n: int) -> float:
    """µs a call's two spans take by their code alone, no RPC: the client
    span opened, the server span opened from the meta the client would
    send and annotated, both ended into the store, ``n`` times. With rpcz
    off the same calls only stamp the ids."""
    body = b"\0" * 256
    t0 = time.perf_counter()
    for _ in range(n):
        cntl = Controller()
        cntl._service, cntl._method, cntl._request_payload = "tensor", "echo", body
        cntl._span = rpcz.start_client_span(cntl)
        meta = Meta(service="tensor", method="echo", trace_id=cntl.trace_id, span_id=cntl.span_id,
                    sampled=cntl.trace_sampled)
        served = Controller(timeout_ms=0)
        served._request_payload = body
        served._span = rpcz.start_server_span(served, meta)
        if served._span is not None:
            served._span.annotate("processing")
        rpcz.clear_parent_span(served._span)
        rpcz.end_server_span(served, response_size=len(body))
        rpcz.end_client_span(cntl)
    return (time.perf_counter() - t0) / n * 1e6


def rpcz_phase(torch, kernels, device=None, scale: float = 1.0):
    """Phase 3i: the device echo (``DeviceEndpoint.server_handler()`` as
    ``tensor.echo``, 256 B, window 16) with ``enable_rpcz`` on, every span
    kept (``RPCZ_FLAGS``), every answer bitwise ``expected()``: (a) on the
    Python plane over tbus_std, each call leaving one client span and one
    server span of its trace, the server's parented to the client's and
    annotated "processing"; (b) baidu_std behind the native plane from
    ``Channel(native_plane=True)`` (the same two spans) and from
    ``NativeClientChannel`` with its own trace (the server span parented to
    the span id it sent), then a flood of ``native_echo`` whose sampled
    spans the telemetry drain turns into exactly one in
    ``RPCZ_SAMPLE_EVERY``; (c) ``POST /tensor/echo`` on the HTTP gateway, a
    server span a call; (d) the pages of ``RPCZ_PAGES`` scraped over the
    port's HTTP channel (ms each), each holding its row; (e) the span cost:
    sequential device echoes with rpcz off and on in mirrored turns, and
    spans a second under a 16 x 8 burst; (f) ``/hotspots/contention`` after
    a contended ``FiberMutex`` loop, naming its call site. K1 is tallied per
    part. Returns (figures, {part: K1 launches}).

    (e) also times a call's two spans by their code alone (``span_code_us``,
    off, on, on, off): the turns of whole calls vary by more than the
    spans cost."""
    from incubator_brpc_tpu_torch.builtin import rpcz
    from incubator_brpc_tpu_torch.protocol.http import http_call
    from incubator_brpc_tpu_torch.protocol.tbus_std import Meta
    from incubator_brpc_tpu_torch.rpc import (
        Channel, ChannelOptions, Controller, Server, ServerOptions, native_echo,
    )
    from incubator_brpc_tpu_torch.runtime import FiberMutex, reset_contention_profile
    from incubator_brpc_tpu_torch.transport import native_plane as np_mod
    from incubator_brpc_tpu_torch.transport.device import DeviceEndpoint
    from incubator_brpc_tpu_torch.utils import flags

    tally = {}

    def counted(part, fn):
        before = kernels.launch_counts()
        try:
            return fn()
        finally:
            after = kernels.launch_counts()
            row = tally.setdefault(part, dict.fromkeys(K1, 0))
            for k in K1:
                row[k] += after[k] - before[k]

    store = rpcz.span_store
    saved = {name: flags.get_flag(name) for name in RPCZ_FLAGS}
    for name, value in RPCZ_FLAGS.items():
        flags.set_flag_unchecked(name, value)
    ep = DeviceEndpoint(window_size=PROTO_WINDOW, max_batch=PROTO_WINDOW, device=device)
    handler = ep.server_handler()
    servers = []

    def start(services, **kw):
        srv = Server(ServerOptions(device=device, **kw))
        for name, hs in services.items():
            srv.add_service(name, hs)
        if not srv.start(0):
            raise AssertionError("phase3i: a Server did not start")
        servers.append(srv)
        return srv

    def channel(port, **kw):
        ch = Channel()
        if not ch.init(f"127.0.0.1:{port}", options=ChannelOptions(timeout_ms=300_000, **kw)):
            raise AssertionError("phase3i: a Channel did not init")
        return ch

    rng = np.random.default_rng(67)

    def payload():
        return rng.integers(0, 256, size=256, dtype=np.uint8).tobytes()

    def spans_of(trace_id, n, label):
        """The ``n`` spans of one trace (a server ends its span after it
        wrote the answer: waited for, 10 s at most)."""
        deadline = time.monotonic() + 10
        while True:
            got = store.by_trace(trace_id)
            if len(got) >= n or time.monotonic() > deadline:
                break
            time.sleep(0.001)
        if len(got) != n:
            raise AssertionError(f"phase3i {label}: trace {trace_id:x} has {len(got)} spans, want {n}")
        return got

    def linked(label, trace_id, client_span_id, spans):
        """One client span of the call and one server span parented to it,
        annotated "processing", both of the device echo."""
        kinds = {sp.span_type: sp for sp in spans}
        cl, sv = kinds.get("client"), kinds.get("server")
        if cl is None or sv is None or cl.span_id != client_span_id or sv.parent_span_id != cl.span_id:
            raise AssertionError(f"phase3i {label}: spans of trace {trace_id:x} not linked: {spans}")
        if [t for _, t in sv.annotations] != ["processing"]:
            raise AssertionError(f"phase3i {label}: server span annotations {sv.annotations}")
        for sp in (cl, sv):
            if (sp.service, sp.method, sp.error_code, sp.request_size) != ("tensor", "echo", 0, 256):
                raise AssertionError(f"phase3i {label}: span {sp}")

    def traced_calls(label, ch, n):
        """``n`` sequential device echoes through ``ch``, each call's client
        and server spans held linked. Returns (µs a call, a trace id)."""
        traces = []
        t0 = time.perf_counter()
        for _ in range(n):
            p = payload()
            cntl = Controller()
            c = ch.call_method("tensor", "echo", p, cntl=cntl)
            echo_check(label, p, c.error_code, c.response_payload, phase="phase3i")
            traces.append((cntl.trace_id, cntl.span_id))
        us = (time.perf_counter() - t0) / n * 1e6
        if len({t for t, _ in traces}) != n:
            raise AssertionError(f"phase3i {label}: calls shared a trace id")
        for trace_id, span_id in traces:
            linked(label, trace_id, span_id, spans_of(trace_id, 2, label))
        return us, traces[-1][0]

    def on_client(label, native_calls, fn):
        """Run ``fn`` and hold that exactly ``native_calls`` of its calls
        rode the native client, none failed (a Channel falls through to the
        Python client quietly, and its spans would link all the same)."""
        before = (np_mod.native_client_calls.get_value(), np_mod.native_client_errors.get_value())
        r = fn()
        got = np_mod.native_client_calls.get_value() - before[0]
        errors = np_mod.native_client_errors.get_value() - before[1]
        if (got, errors) != (native_calls, 0):
            raise AssertionError(f"phase3i {label}: {got} native client calls ({errors} failed), "
                                 f"{native_calls} expected; the call took the wrong client")
        return r

    n_seq = max(4, int(RPCZ_SEQ * scale))
    out = {}
    try:
        ep.warm(256)
        py_srv = start({"tensor": {"echo": handler}})
        nat_srv = start({"tensor": {"echo": handler}, "bench": {"echo": native_echo}}, native_plane=True)

        # (a) the Python plane over tbus_std ---------------------------------
        store.clear()
        py_ch = channel(py_srv.port)
        a_us, a_trace = on_client("(a)", 0,
                                  lambda: counted("a", lambda: traced_calls("(a)", py_ch, n_seq)))
        out["a"] = {"seq_us": a_us, "calls": n_seq, "spans": 2 * n_seq}
        log(f"phase3i (a) tbus_std on the Python plane, device echo 256 B with rpcz on: {n_seq} calls, "
            f"each a client span and a server span of its own trace, the server's parented to the "
            f"client's and annotated 'processing'; {a_us:.1f} us a call; launches "
            f"{[tally['a'][k] for k in K1]}")

        # (b) baidu_std behind the native plane --------------------------------
        nat_ch = channel(nat_srv.port, protocol="baidu_std", native_plane=True)
        b_us, _ = on_client("(b) Channel", n_seq,
                            lambda: counted("b", lambda: traced_calls("(b) Channel", nat_ch, n_seq)))
        if nat_ch._native_ch is None:
            raise AssertionError("phase3i (b): the Channel did not ride the native client")
        nch = np_mod.NativeClientChannel("127.0.0.1", nat_srv.port, protocol="baidu_std")

        def native_traced():
            for i in range(n_seq):
                p = payload()
                rc, code, _m, body = nch.call("tensor", "echo", p, timeout_ms=300_000,
                                              trace_id=RPCZ_TRACE, span_id=1000 + i, sampled=1)
                if rc < 0:
                    raise AssertionError(f"phase3i (b): native client transport errno {-rc}")
                echo_check("(b) NativeClientChannel", p, code, body.to_bytes(), phase="phase3i")

        on_client("(b) NativeClientChannel", n_seq, lambda: counted("b", native_traced))
        got = spans_of(RPCZ_TRACE, n_seq, "(b) NativeClientChannel")
        if sorted(sp.parent_span_id for sp in got) != list(range(1000, 1000 + n_seq)) or any(
                sp.span_type != "server" or sp.method != "echo" for sp in got):
            raise AssertionError("phase3i (b): the native client's trace did not reach the server spans")
        before = len(store)
        n_pump = max(256, int(RPCZ_NATIVE_PUMP * scale)) // RPCZ_SAMPLE_EVERY * RPCZ_SAMPLE_EVERY
        t0 = time.perf_counter()
        pump_ns = nch.pump("bench", "echo", b"n" * 256, n_pump, inflight=32)
        nat_srv._native_plane.drain_telemetry()
        drained_s = time.perf_counter() - t0
        nch.close()
        sampled = [sp for sp in store.recent(limit=len(store)) if sp.service == "bench"]
        st = nat_srv._native_plane.stats()
        if len(sampled) != n_pump // RPCZ_SAMPLE_EVERY or len(store) - before != len(sampled):
            raise AssertionError(f"phase3i (b): {len(sampled)} sampled native spans of {n_pump} "
                                 f"requests at 1 in {RPCZ_SAMPLE_EVERY}")
        out["b"] = {"channel_seq_us": b_us, "native_traced_calls": n_seq, "pump": n_pump,
                    "pump_ns": pump_ns, "sampled_spans": len(sampled),
                    "sampled_spans_per_s": len(sampled) / drained_s, "cb_frames": st["cb_frames"]}
        log(f"phase3i (b) baidu_std behind the native plane: Channel(native_plane=True) {b_us:.1f} us a "
            f"call, its spans linked as in (a); NativeClientChannel with trace {RPCZ_TRACE:x}: "
            f"{n_seq} server spans parented to the span ids it sent; a native_echo flood of {n_pump} "
            f"(pump {pump_ns:.0f} ns a request) left {len(sampled)} sampled spans, one in "
            f"{RPCZ_SAMPLE_EVERY} exactly; launches {[tally['b'][k] for k in K1]}")

        # (c) the HTTP gateway -------------------------------------------------------
        before = len(store)
        gw = KeepAliveHttp(py_srv.port)

        def gateway():
            for _ in range(n_seq):
                p = payload()
                status, headers, body = gw.post("/tensor/echo", p)
                if status != 200:
                    raise AssertionError(f"phase3i (c) gateway: HTTP {status} {body[:200]!r}")
                echo_check("(c) gateway", p, 0, body, phase="phase3i")

        t0 = time.perf_counter()
        counted("c", gateway)
        c_us = (time.perf_counter() - t0) / n_seq * 1e6
        gw.close()
        deadline = time.monotonic() + 10
        while len(store) < before + n_seq and time.monotonic() < deadline:
            time.sleep(0.001)
        gw_spans = store.recent(limit=len(store))[before:]
        if len(gw_spans) != n_seq or any(
                (sp.span_type, sp.service, sp.method, sp.request_size) != ("server", "tensor", "echo", 256)
                for sp in gw_spans):
            raise AssertionError(f"phase3i (c): {len(gw_spans)} gateway spans, want {n_seq} server spans")
        out["c"] = {"seq_us": c_us, "spans": len(gw_spans)}
        log(f"phase3i (c) POST /tensor/echo on the gateway: {c_us:.1f} us a call, a server span each "
            f"({len(gw_spans)}); launches {[tally['c'][k] for k in K1]}")

        # (d) the portal over the port's HTTP channel ---------------------------
        http_ch = channel(py_srv.port, protocol="http")

        def get(path):
            cntl = Controller()
            cntl.request_extra.update(http_method="GET", http_path=path)
            t0 = time.perf_counter()
            c = http_ch.call_method("", "", b"", cntl=cntl)
            ms = (time.perf_counter() - t0) * 1e3
            if not c.ok():
                raise AssertionError(f"phase3i (d) {path}: {c.error_code} {c.error_text}")
            return c.response_payload.decode(), ms

        d = {}
        for path in RPCZ_PAGES:
            path = path.format(trace=f"{a_trace:x}")
            body, ms = get(path)
            d[path] = {"ms": ms, "bytes": len(body)}
            if path.startswith("/rpcz?trace_id="):
                lines = body.splitlines()
                ok = (len(lines) == 2 and " client tensor.echo " in lines[0]
                      and lines[1].startswith("  ") and " server tensor.echo " in lines[1])
            elif path == "/rpcz":
                ok = "tensor.echo" in body
            elif path == "/vars":
                ok = "method_tensor_echo_latency : " in body
            elif path == "/vars.json":
                ok = "method_tensor_echo_latency" in json.loads(body)
            elif path == "/brpc_metrics":
                validate_exposition(body)
                ok = "# TYPE method_tensor_echo_latency summary" in body
            elif path == "/status":
                ok = "tensor.echo: processing=" in body
            elif path == "/flags":
                ok = "enable_rpcz True " in body
            elif path == "/connections":
                ok = f"{py_srv.listen_endpoint} connections=" in body
            else:
                ok = body.startswith("live sockets: ")
            if not ok:
                raise AssertionError(f"phase3i (d) {path}: the page lacks its row:\n{body[:1500]}")
        status, _, raw = http_call("127.0.0.1", nat_srv.port, "/brpc_metrics?prefix=native_method_bench",
                                   timeout=60)
        nat_metrics = raw.decode()
        if status != 200:
            raise AssertionError(f"phase3i (d): the native plane's /brpc_metrics answered {status}")
        validate_exposition(nat_metrics)
        if f"native_method_bench_echo_latency_us_count {n_pump}" not in nat_metrics:
            raise AssertionError(f"phase3i (d): the native summary did not count the flood:\n{nat_metrics}")
        out["d"] = d
        log(f"phase3i (d) the portal over ChannelOptions(protocol='http'), ms a scrape: "
            + ", ".join(f"{k} {v['ms']:.2f} ({v['bytes']} B)" for k, v in d.items())
            + f"; the exposition valid, the native plane's summary of the flood counted by the "
              "scrape hook's drain")

        # (e) the span cost: rpcz off and on in mirrored turns ------------------------
        cost_ch = channel(py_srv.port)
        n_turn = max(20, int(RPCZ_TURN_CALLS * scale))
        turns = {False: [], True: []}

        def turn(on):
            flags.set_flag_unchecked("enable_rpcz", on)
            ps = [payload() for _ in range(n_turn)]
            t0 = time.perf_counter()
            for p in ps:
                c = cost_ch.call_method("tensor", "echo", p)
                echo_check("(e)", p, c.error_code, c.response_payload, phase="phase3i")
            turns[on].append((time.perf_counter() - t0) / n_turn * 1e6)

        order = [bool((i + 1) // 2 % 2) for i in range(RPCZ_TURNS)]  # off, on, on, off, off, on
        for on in order:
            counted("e", lambda: turn(on))
        flags.set_flag_unchecked("enable_rpcz", True)
        n_threads, per = RPCZ_BURST[0], max(1, int(RPCZ_BURST[1] * scale))
        burst = [[payload() for _ in range(per)] for _ in range(n_threads)]
        burst_traces = []

        def caller(i):
            for p in burst[i]:
                cntl = Controller()
                c = cost_ch.call_method("tensor", "echo", p, cntl=cntl)
                echo_check("(e) burst", p, c.error_code, c.response_payload, phase="phase3i")
                burst_traces.append(cntl.trace_id)

        t0 = time.perf_counter()
        counted("e", lambda: call_threads(n_threads, caller))
        wall = time.perf_counter() - t0
        for trace_id in burst_traces:
            spans_of(trace_id, 2, "(e) burst")
        off_us, on_us = sum(turns[False]) / len(turns[False]), sum(turns[True]) / len(turns[True])
        burst_spans = 2 * len(burst_traces)
        n_loops = max(200, int(RPCZ_SPAN_LOOPS * scale))
        code = {False: [], True: []}
        for on in (False, True, True, False):
            flags.set_flag_unchecked("enable_rpcz", on)
            store.clear()
            code[on].append(span_code_us(rpcz, Controller, Meta, n_loops))
        flags.set_flag_unchecked("enable_rpcz", True)
        out["e"] = {"off_us": turns[False], "on_us": turns[True], "order": order,
                    "span_cost_us": on_us - off_us, "burst_calls_per_s": n_threads * per / wall,
                    "burst_spans_per_s": burst_spans / wall, "span_code_off_us": code[False],
                    "span_code_on_us": code[True],
                    "span_code_us": sum(code[True]) / 2 - sum(code[False]) / 2}
        log(f"phase3i (e) the span cost, {n_turn} sequential device echoes a turn over tbus_std, turns "
            f"{['on' if o else 'off' for o in order]}: rpcz off "
            + ", ".join(f"{v:.1f}" for v in turns[False]) + " us a call, on "
            + ", ".join(f"{v:.1f}" for v in turns[True])
            + f" us a call: {on_us - off_us:.1f} us a call for its two spans; a {n_threads} x {per} "
              f"burst with rpcz on: {n_threads * per / wall:.1f} calls/s, {burst_spans / wall:.1f} "
              f"spans/s; launches {[tally['e'][k] for k in K1]}; the two spans' code alone, "
              f"{n_loops} times in turns (off, on, on, off): off "
            + ", ".join(f"{v:.2f}" for v in code[False]) + ", on "
            + ", ".join(f"{v:.2f}" for v in code[True])
            + f" us a call: {out['e']['span_code_us']:.2f} us for its two spans")

        # (f) the contention profile ------------------------------------------------
        reset_contention_profile()
        mutex = FiberMutex()
        workers = [threading.Thread(target=contended_worker, args=(mutex, 20)) for _ in range(2)]
        for t in workers:
            t.start()
        for t in workers:
            t.join()
        body, ms = get("/hotspots/contention")
        if "contended acquires: " not in body or "in contended_worker" not in body:
            raise AssertionError(f"phase3i (f): the contention page does not name the loop:\n{body[:1500]}")
        out["f"] = {"ms": ms, "contended": int(body.split("contended acquires: ", 1)[1].split()[0])}
        log(f"phase3i (f) /hotspots/contention after 2 threads x 20 rounds on one FiberMutex: "
            f"{out['f']['contended']} contended acquires, the call site contended_worker named "
            f"({ms:.2f} ms)")
    finally:
        for s in servers:
            s.stop()
            s.join(timeout=60)
        for name, value in saved.items():
            flags.set_flag_unchecked(name, value)
        store.clear()
        if not ep.close(timeout=120):
            raise AssertionError("phase3i: the endpoint did not settle its calls")
    return out, tally


def k3_tolerances(torch):
    """|kernel - plain| <= tol * max(1, max |plain|). f32 results: 2e-5 (the
    same f32 arithmetic, sums in another order); results in bf16: 2^-7, one
    rounding of the f32 result to bf16 on either side."""
    return {torch.float32: 2e-5, torch.bfloat16: 2.0 ** -7}


def err_within(torch, name, got, want, tol, errs):
    err = float((got.float() - want.float()).abs().max())
    scale = max(1.0, float(want.float().abs().max()))
    errs[name] = max(errs.get(name, 0.0), err)
    if not err <= tol * scale:
        raise AssertionError(f"{name}: max abs err {err} > {tol} x {scale}")
    return f"{name} {err:.3g} (tol {tol * scale:.3g})"


def delta_forms_since(attention, before) -> dict:
    """``attn_bwd_delta``'s launches since ``before``
    (``attention.delta_form_counts()``) by form: {(form, lanes a row): n}."""
    after = attention.delta_form_counts()
    return {f: n - before.get(f, 0) for f, n in after.items() if n > before.get(f, 0)}


def k3_case(torch, attention, gen, dev, shape, dtype, causal, errs):
    """K3 forward and backward against the plain versions on the same inputs."""
    b, t, h, d, sp = shape
    q, k, v, dout = (torch.randn((b, t, h, d), generator=gen, device=dev).to(dtype)
                     for _ in range(4))
    tol = k3_tolerances(torch)
    f32 = tol[torch.float32]
    out, lse, (m, l, o) = attention.forward(q, k, v, sp=sp, causal=causal)
    state = None
    for hop in range(sp):
        state = attention.fold_plain(q, k, v, state, hop=hop, sp=sp, causal=causal)
    want_out, want_lse = attention.finalize_plain(state, dtype)
    before = attention.delta_form_counts()
    delta = attention.row_dot(out, dout)
    form = attention.delta_form(d, dtype, True)
    if delta_forms_since(attention, before) != {form: 1}:
        raise AssertionError(f"attn_bwd_delta at D={d} {dtype}: ran "
                             f"{delta_forms_since(attention, before)}; delta_form names {form}")
    want_delta = attention.row_dot_plain(out, dout)
    dk, dv = attention.dkdv(q, k, v, dout, lse, delta, sp=sp, causal=causal)
    dq = attention.dq(q, k, v, dout, lse, delta, sp=sp, causal=causal)
    want_dk, want_dv = attention.dkdv_plain(q, k, v, dout, lse, want_delta, sp=sp, causal=causal)
    want_dq = attention.dq_plain(q, k, v, dout, lse, want_delta, sp=sp, causal=causal)
    torch.cuda.synchronize()
    name = str(dtype)[6:]
    fold, dkdv, dqe = errs[FOLD[name]], errs[DKDV[name]], errs[DQ[name]]
    parts = [
        err_within(torch, "out", out, want_out, tol[dtype], fold),
        err_within(torch, "m", m, state[0], f32, fold),
        err_within(torch, "l", l, state[1], f32, fold),
        err_within(torch, "o", o, state[2], f32, fold),
        err_within(torch, "lse", lse, want_lse, f32, fold),
        err_within(torch, f"delta ({form[0]} form, {form[1]} lanes a row)", delta, want_delta, f32,
                   errs["attn_bwd_delta"]),
        err_within(torch, "delta (general form)", attention._launch_delta(out, dout, GENERAL),
                   want_delta, f32, errs["attn_bwd_delta"]),
        err_within(torch, "dk", dk, want_dk, tol[dtype], dkdv),
        err_within(torch, "dv", dv, want_dv, tol[dtype], dkdv),
        err_within(torch, "dq", dq, want_dq, tol[dtype], dqe),
    ]
    log(f"phase5 K3 B={b} T={t} H={h} D={d} sp={sp} {name} "
        f"{'causal' if causal else 'full'} ({FOLD[name]}, {DKDV[name]}, {DQ[name]}): "
        + "; ".join(parts))


def delta_case(torch, attention, gen, dev, d, dtype, errs):
    """``attn_bwd_delta`` at D = d on ``DELTA_ROWS`` rows: the launch in the
    form ``delta_form`` names, and the general form beside a vector one,
    each within the f32 tolerance of ``row_dot_plain``; where the rows are
    off the vector form's alignments, a vector launch refused."""
    out, dout = (torch.randn(DELTA_ROWS + (d,), generator=gen, device=dev).to(dtype)
                 for _ in range(2))
    want = attention.row_dot_plain(out, dout)
    tol = k3_tolerances(torch)[torch.float32]
    form = attention.delta_form(d, dtype, True)
    before = attention.delta_form_counts()
    got = attention.row_dot(out, dout)
    if delta_forms_since(attention, before) != {form: 1}:
        raise AssertionError(f"attn_bwd_delta at D={d} {dtype}: ran "
                             f"{delta_forms_since(attention, before)}; delta_form names {form}")
    parts = [err_within(torch, f"{form[0]} form, {form[1]} lanes a row", got, want, tol, errs)]
    if form[0] == "vector":
        parts.append(err_within(torch, "general form", attention._launch_delta(out, dout, GENERAL),
                                want, tol, errs))
    else:
        try:  # the lanes a 16-byte row of this D would take
            attention._launch_delta(out, dout, ("vector", form[1]))
        except RuntimeError:
            parts.append("a vector launch refused")
        else:
            raise AssertionError(f"attn_bwd_delta at D={d} {dtype}: a vector launch off its "
                                 "alignments ran")
    torch.cuda.synchronize()
    log(f"phase5 attn_bwd_delta {DELTA_ROWS} rows, D={d} {str(dtype)[6:]}: " + "; ".join(parts))
    return form


def k3_layout_case(torch, attention, gen, dev, shape, dtype, errs):
    """K3 on transposed views and on tensors one element past 16-byte
    alignment: bitwise what contiguous copies give (the wrappers copy such
    tensors; JAX takes any layout), and dK/dV and dQ within the tolerances
    of the plain versions on the misaligned inputs."""
    b, t, h, d, sp = shape
    dense = [torch.randn((b, t, h, d), generator=gen, device=dev).to(dtype) for _ in range(4)]

    def run(q, k, v, dout):
        out, lse, _ = attention.forward(q, k, v, sp=sp, causal=True)
        return (out, lse) + attention.backward(q, k, v, out, dout, lse, sp=sp, causal=True)

    def shifted(x):
        y = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)[1:].view(x.shape)
        return y.copy_(x)

    want = run(*dense)
    for name, inputs in (("transposed views", [x.transpose(1, 2).contiguous().transpose(1, 2)
                                               for x in dense]),
                         ("one element off alignment", [shifted(x) for x in dense])):
        if any(x.is_contiguous() and x.data_ptr() % 16 == 0 for x in inputs):
            raise AssertionError(f"K3 layout case {name}: an input is dense")
        got = run(*inputs)
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"K3 on {name} differs from contiguous copies")
    q, k, v, dout = inputs
    out, lse, dq, dk, dv = got
    delta = attention.row_dot_plain(out, dout)
    want_dk, want_dv = attention.dkdv_plain(q, k, v, dout, lse, delta, sp=sp, causal=True)
    want_dq = attention.dq_plain(q, k, v, dout, lse, delta, sp=sp, causal=True)
    name = str(dtype)[6:]
    tol, kern, dq_kern = k3_tolerances(torch)[dtype], DKDV[name], DQ[name]
    parts = [err_within(torch, "dk", dk, want_dk, tol, errs[kern]),
             err_within(torch, "dv", dv, want_dv, tol, errs[kern]),
             err_within(torch, "dq", dq, want_dq, tol, errs[dq_kern])]
    log(f"phase5 K3 B={b} T={t} H={h} D={d} sp={sp} {name} causal on transposed views "
        f"and on tensors one element off 16-byte alignment: bitwise the contiguous copies' result; "
        f"{kern} and {dq_kern} on the misaligned inputs against dkdv_plain and dq_plain: "
        + "; ".join(parts))


def k3_bounds(flops, nbytes, peak=F32_FLOPS_PER_S):
    """(bound ms, what bounds it, tensor-core bound ms): ops over the peak of
    the units that do them (the f32 CUDA cores for the CUDA-core kernels,
    bf16 tensor cores for ``attn_fold_fwd_tc``, whose P split's third
    product counts as no work) or bytes over HBM, the larger."""
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by = "operations" if t_ops >= t_bytes else "bytes"
    return max(t_ops, t_bytes), by, flops / BF16_TC_FLOPS_PER_S * 1e3


def fold_bytes(n, stats, itemsize):
    """What a full forward must move: q, k, v read, out written (in the
    operands' dtype), the f32 running o written, and m, l, lse written."""
    return 3 * itemsize * n + itemsize * n + 4 * n + 3 * stats


def dkdv_bytes(n, stats, itemsize):
    """What dK/dV must move: q, k, v, dout, lse and delta read, dk and dv
    written."""
    return 4 * itemsize * n + 2 * stats + 2 * itemsize * n


def dq_bytes(n, stats, itemsize):
    """What dQ must move: q, k, v, dout, lse and delta read, dq written."""
    return 4 * itemsize * n + 2 * stats + itemsize * n


def k3_timings(torch, attention, gen, dev, sp):
    """CUDA-event times at the bench attention shape, bf16, causal: the
    tensor-core fold and the backward kernels."""
    import torch.nn.functional as F

    b, t, h, d = BENCH_ATTN
    n = b * t * h * d
    q, k, v, dout = (torch.randn(BENCH_ATTN, generator=gen, device=dev).to(torch.bfloat16)
                     for _ in range(4))
    out, lse, _ = attention.forward(q, k, v, sp=sp, causal=True)
    delta = attention.row_dot(out, dout)
    stats = 4 * b * h * t  # one f32 (B, H, T) statistic

    def plain_fwd():
        st = None
        for hop in range(sp):
            st = attention.fold_plain(q, k, v, st, hop=hop, sp=sp, causal=True)
        return attention.finalize_plain(st, q.dtype)

    flops = {p: attention.attention_flops(b, t, h, d, causal=True, products=p) for p in (2, 3, 4)}
    tensor_cores = (FOLD["bfloat16"], DKDV["bfloat16"], DQ["bfloat16"])
    cases = {
        # name: (kernel, plain, flops, bytes: inputs read once, outputs written once)
        "attn_fold_fwd_tc": (lambda: attention.forward(q, k, v, sp=sp, causal=True), plain_fwd,
                             flops[2], fold_bytes(n, stats, 2)),
        "attn_bwd_dkdv_tc": (lambda: attention.dkdv(q, k, v, dout, lse, delta, sp=sp, causal=True),
                             lambda: attention.dkdv_plain(q, k, v, dout, lse, delta, sp=sp,
                                                          causal=True),
                             flops[4], dkdv_bytes(n, stats, 2)),
        "attn_bwd_dq_tc": (lambda: attention.dq(q, k, v, dout, lse, delta, sp=sp, causal=True),
                           lambda: attention.dq_plain(q, k, v, dout, lse, delta, sp=sp,
                                                      causal=True),
                           flops[3], dq_bytes(n, stats, 2)),
    }
    res = {}
    for name, (kern, plain, fl, nbytes) in cases.items():
        bound, by, tc = k3_bounds(fl, nbytes, BF16_TC_FLOPS_PER_S if name in tensor_cores
                                  else F32_FLOPS_PER_S)
        res[name] = {"ms": time_ms(torch, kern, 10), "plain_ms": time_ms(torch, plain, 3, warmup=1),
                     "bound_ms": bound, "bound_by": by, "tensor_core_bound_ms": tc,
                     "flops": fl, "bytes": nbytes}
    res["backward"] = {"ms": time_ms(torch, lambda: attention.backward(
        q, k, v, out, dout, lse, sp=sp, causal=True), 10)}
    if sp == 1:  # B 1: 64 blocks, fewer than the SMs, each as heavy as at B 4
        q1, k1, v1 = (x[:1].contiguous() for x in (q, k, v))
        res["fold_b1_ms"] = time_ms(torch, lambda: attention.forward(q1, k1, v1, sp=1,
                                                                     causal=True), 10)
    # the yardstick the port never calls: one PyTorch call, (B, H, T, D)
    qt, kt, vt, dt = (x.transpose(1, 2).contiguous() for x in (q, k, v, dout))
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)  # noqa: E731
    qg, kg, vg = (x.detach().requires_grad_() for x in (qt, kt, vt))

    def sdpa_fwd_bwd():
        F.scaled_dot_product_attention(qg, kg, vg, is_causal=True).backward(dt)

    res["sdpa_fwd_ms"] = time_ms(torch, sdpa, 10)
    res["sdpa_fwd_bwd_ms"] = time_ms(torch, sdpa_fwd_bwd, 10)
    parts = [f"{name} {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} by {r['bound_by']}, "
             f"{100 * r['bound_ms'] / r['ms']:.1f} %; tensor-core bound {r['tensor_core_bound_ms']:.4f}; "
             f"plain {r['plain_ms']:.4f})" for name, r in res.items() if name in K3]
    log(f"phase8 K3 timings B={b} T={t} H={h} D={d} bf16 causal sp={sp} "
        f"({sp if sp > 1 else 1} fold launches): " + "; ".join(parts)
        + (f"; attn_fold_fwd_tc at B=1 (64 blocks) {res['fold_b1_ms']:.4f} ms" if sp == 1 else "")
        + f"; backward (3 kernels) {res['backward']['ms']:.4f} ms; "
        f"scaled_dot_product_attention fwd {res['sdpa_fwd_ms']:.4f} ms, "
        f"fwd+bwd {res['sdpa_fwd_bwd_ms']:.4f} ms")
    return res


def delta_timings(torch, attention, gen, dev):
    """``attn_bwd_delta`` at the bench attention shape in bf16 (the bench's
    dtype) and f32, both forms in turns (general, vector, vector, general;
    the general form is the kernel that preceded the vector form): device
    time behind a spin kernel on inputs that arrive cold (the calls rotate
    over input pairs that fill ``DELTA_ROTATE_BYTES``, past the L2, as the
    step's out and dout arrive) and on one pair again and again
    (``warm_ms``: bf16's 32 MiB stay in the 50 MB L2), beside the bound
    (the bytes of out and dout read and delta written), the plain version,
    a cold ``copy_`` and, in f32, ``torch.linalg.vecdot``; and the wrapper
    back to back (``host_ms``), the rate a caller sees with the host's cost
    of each call on the clock."""
    b, t, h, d = BENCH_ATTN
    n = b * t * h * d
    res = {}
    for dtype in (torch.bfloat16, torch.float32):
        pair_bytes = 2 * n * torch.empty((), dtype=dtype).element_size()
        pairs = [tuple(torch.randn(BENCH_ATTN, generator=gen, device=dev).to(dtype)
                       for _ in range(2)) for _ in range(math.ceil(DELTA_ROTATE_BYTES / pair_bytes))]
        out, dout = pairs[0]
        nbytes = pair_bytes + 4 * b * h * t
        bound, by, _ = k3_bounds(2 * n, nbytes)
        form = attention.delta_form(d, dtype, True)
        turns, ran = {"general": [], "vector": []}, []
        for f in DELTA_TURNS:
            launch = form if f == "vector" else GENERAL
            calls = iter(range(1 << 30))
            cold, queued = device_ms(torch, lambda: attention._launch_delta(
                *pairs[next(calls) % len(pairs)], launch), 50)
            warm, _ = device_ms(torch, lambda: attention._launch_delta(out, dout, launch), 50)
            turns[f].append({"ms": cold, "warm_ms": warm, "queued_in_time": queued})
            ran.append(f"{f} {cold:.6f} / {warm:.6f} ms ({100 * bound / cold:.1f} / "
                       f"{100 * bound / warm:.1f} %)" + ("" if queued else " host-bound"))
        # yardsticks, cold as above: a copy_ that reads and writes out's bytes
        # (delta's bytes in bf16: what the card's own copy reaches at this
        # size), and torch.linalg.vecdot, one PyTorch call that computes delta
        # in f32 (in its (B, T, H) layout; in bf16 it rounds its result to
        # bf16, not the same function)
        dst = torch.empty_like(out)
        calls = iter(range(1 << 30))
        copy_ms, _ = device_ms(torch, lambda: dst.copy_(pairs[next(calls) % len(pairs)][0]), 50)
        library_ms = None
        if dtype == torch.float32:
            calls = iter(range(1 << 30))
            library_ms, _ = device_ms(torch, lambda: torch.linalg.vecdot(
                *pairs[next(calls) % len(pairs)]), 50)
        kern = lambda: attention.row_dot(out, dout)  # noqa: E731
        mean = {f: sum(r["ms"] for r in v) / len(v) for f, v in turns.items()}
        r = res[str(dtype)[6:]] = {
            "form": f"{form[0]} {form[1]}", "ms": mean[form[0]], "general_ms": mean["general"],
            "warm_ms": sum(r["warm_ms"] for r in turns[form[0]]) / len(turns[form[0]]),
            "turns": turns,
            "queued_in_time": all(r["queued_in_time"] for v in turns.values() for r in v),
            "host_ms": time_ms(torch, kern, 50),
            "plain_ms": device_ms(torch, lambda: attention.row_dot_plain(out, dout), 10)[0],
            "bound_ms": bound, "bound_by": by, "bytes": nbytes, "flops": 2 * n,
            "input_pairs": len(pairs), "copy_ms": copy_ms, "library_ms": library_ms}
        log(f"phase8 attn_bwd_delta B={b} T={t} H={h} D={d} {str(dtype)[6:]}, device time behind "
            f"a spin kernel, cold ({len(pairs)} input pairs in rotation) / warm (one pair), in "
            f"turns: " + ", ".join(ran) + f"; bound {bound:.6f} ms by {by}; delta_form: "
            f"{r['form']} lanes a row; back to back {r['host_ms']:.6f} ms; plain "
            f"{r['plain_ms']:.6f} ms; copy_ of out {copy_ms:.6f} ms; torch.linalg.vecdot "
            + (f"{library_ms:.6f} ms" if library_ms else "not the same function in bf16"))
    return res


def k3_f32_timings(torch, attention, gen, dev):
    """CUDA-event times of the kernels float32 operands take, at the bench
    attention shape, causal, sp 1: the fold, dK/dV and dQ on the tensor
    cores in 3xTF32 (their bounds: three tf32 products for each of the
    function's, at the TF32 tensor-core peak, or their f32 bytes, the
    larger; beside each the f32-FMA bound of the CUDA-core kernel it
    replaced), each beside its plain version; SDPA's forward and its backward
    (forward + backward less forward) on the same f32 tensors, the backward
    beside the three f32 backward kernels together, which compute its
    function."""
    import torch.nn.functional as F

    b, t, h, d = BENCH_ATTN
    n = b * t * h * d
    stats = 4 * b * h * t
    q, k, v, dout = (torch.randn(BENCH_ATTN, generator=gen, device=dev) for _ in range(4))
    out, lse, _ = attention.forward(q, k, v, sp=1, causal=True)
    delta = attention.row_dot(out, dout)

    def plain_fwd():
        return attention.finalize_plain(
            attention.fold_plain(q, k, v, None, hop=0, sp=1, causal=True), q.dtype)

    cases = {
        FOLD["float32"]: (lambda: attention.forward(q, k, v, sp=1, causal=True), plain_fwd, 2,
                          fold_bytes(n, stats, 4)),
        DKDV["float32"]: (lambda: attention.dkdv(q, k, v, dout, lse, delta, sp=1, causal=True),
                          lambda: attention.dkdv_plain(q, k, v, dout, lse, delta, sp=1, causal=True),
                          4, dkdv_bytes(n, stats, 4)),
        DQ["float32"]: (lambda: attention.dq(q, k, v, dout, lse, delta, sp=1, causal=True),
                        lambda: attention.dq_plain(q, k, v, dout, lse, delta, sp=1, causal=True),
                        3, dq_bytes(n, stats, 4)),
    }
    res = {}
    for name, (kern, plain, products, nbytes) in cases.items():
        fl = attention.attention_flops(b, t, h, d, causal=True, products=products)
        # 3xTF32: three tf32 products for each
        bound, by, _ = k3_bounds(3 * fl, nbytes, TF32_TC_FLOPS_PER_S)
        extra = {"tensor_core_bound_ms": 3 * fl / TF32_TC_FLOPS_PER_S * 1e3, "tf32_flops": 3 * fl,
                 "f32_fma_bound_ms": fl / F32_FLOPS_PER_S * 1e3}
        res[name] = {"ms": time_ms(torch, kern, 10), "plain_ms": time_ms(torch, plain, 3, warmup=1),
                     "bound_ms": bound, "bound_by": by, "flops": fl, "bytes": nbytes,
                     "library_ms": None, **extra}
    backward_ms = time_ms(torch, lambda: attention.backward(q, k, v, out, dout, lse, sp=1,
                                                            causal=True), 10)
    # the yardstick the port never calls: one PyTorch call, (B, H, T, D), f32
    qt, kt, vt, dt = (x.transpose(1, 2).contiguous() for x in (q, k, v, dout))
    qg, kg, vg = (x.detach().requires_grad_() for x in (qt, kt, vt))

    def sdpa_fwd_bwd():
        F.scaled_dot_product_attention(qg, kg, vg, is_causal=True).backward(dt)

    sdpa_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True),
                       10)
    sdpa_bwd = time_ms(torch, sdpa_fwd_bwd, 10) - sdpa_fwd
    res[FOLD["float32"]]["library_ms"] = sdpa_fwd
    for name in (DKDV["float32"], DQ["float32"]):
        res[name].update(backward_ms=backward_ms, sdpa_backward_ms=sdpa_bwd)
    log(f"phase8 f32 operands B={b} T={t} H={h} D={d} causal sp=1: " + "; ".join(
        f"{name} {r['ms']:.6f} ms (bound {r['bound_ms']:.6f} by {r['bound_by']}, "
        f"{100 * r['bound_ms'] / r['ms']:.1f} %; plain {r['plain_ms']:.6f})"
        for name, r in res.items())
        + "".join(f"; {n}'s bound as 3xTF32 ({res[n]['tf32_flops'] / 1e9:.2f} GFLOP at "
                  f"{TF32_TC_FLOPS_PER_S / 1e12:.1f} TFLOP/s), the CUDA-core kernel's f32-FMA "
                  f"bound {res[n]['f32_fma_bound_ms']:.6f} ms" for n in K3_F32)
        + f"; scaled_dot_product_attention f32 fwd "
        f"{sdpa_fwd:.6f} ms, bwd {sdpa_bwd:.6f} ms; the three f32 backward kernels "
        f"(attn_bwd_delta, {DKDV['float32']}, {DQ['float32']}) {backward_ms:.6f} ms")
    return res


# -- K4: FabricNet's elementwise chain (phases 5, 7 and 8) ----------------------


def ulps(torch, a, b):
    """|a - b| elementwise in units in the last place of their dtype (bf16
    or f32), from the bit patterns in sign-magnitude order."""
    it, mag = {torch.bfloat16: (torch.int16, 0x7FFF),
               torch.float32: (torch.int32, 0x7FFFFFFF)}[a.dtype]

    def ordered(t):
        i = t.contiguous().view(it).to(torch.int64)
        return torch.where(i < 0, -(i & mag), i)

    return (ordered(a) - ordered(b)).abs()


def k4_case(torch, E, gen, dev, shape, dtype, offset, errs, gelu_diff):
    """K4 against its plain versions on the same inputs: K4a with and
    without delta (s bitwise, n and rstd within ``NORM_TOL``), K4b with and
    without g_s bit for bit, K4c and K4d bit for bit but for elements within
    ``TRANSCENDENTAL_ULPS`` (tanhf), counted into ``gelu_diff``. ``offset``:
    every input one element into a buffer, off 16-byte alignment."""

    def make(scale):
        t = (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)
        if offset:
            t = torch.empty(t.numel() + 1, dtype=dtype, device=dev)[1:].view(shape).copy_(t)
        return t

    x, delta, g_s, g_n = make(2.0), make(1.0), make(1.0), make(1.0)
    name = str(dtype)[6:]
    parts = []
    for dl in (delta, None):
        s, n, rstd = E.add_rms_norm_fwd(x, dl)
        want_s, want_n, want_r = E.add_rms_norm_plain(x, dl)
        torch.cuda.synchronize()
        if not torch.equal(s, want_s):
            raise AssertionError(f"add_rms_norm_fwd {shape} {name}: s differs from x + delta")
        tag = "" if dl is None else "+delta "
        parts += [err_within(torch, f"{tag}n", n, want_n, E.NORM_TOL[dtype],
                             errs["add_rms_norm_fwd"]),
                  err_within(torch, f"{tag}rstd", rstd, want_r, E.NORM_TOL[dtype],
                             errs["add_rms_norm_fwd"])]
    s, _, rstd = E.add_rms_norm_plain(x, delta)
    for gs in (g_s, None):
        parts.append(hold(torch, f"rms_norm_bwd {tuple(shape)} {name}",
                          "g" if gs is None else "g+g_s", E.rms_norm_bwd(s, rstd, g_n, gs),
                          E.rms_norm_bwd_plain(s, rstd, g_n, gs), None, errs["rms_norm_bwd"]))
    for kname, tag, got, want in (
            ("gelu_tanh_fwd", "gelu", E.gelu_tanh_fwd(x), E.gelu_plain(x)),
            ("gelu_tanh_bwd", "gelu'", E.gelu_tanh_bwd(x, g_n), E.gelu_bwd_plain(x, g_n))):
        parts.append(hold(torch, f"{kname} {tuple(shape)} {name}", tag, got, want,
                          E.TRANSCENDENTAL_ULPS, errs[kname], gelu_diff.setdefault(kname, {})))
    log(f"phase5 K4 {tuple(shape)} {name}"
        f"{' one element off 16-byte alignment' if offset else ''}: " + "; ".join(parts))


def k4a_cap_case(torch, E, gen, dev, dtype_name, d, offset, errs):
    """K4a on one side of the widths it keeps in registers: 3 rows of width
    ``d`` (inputs one element into their buffers where ``offset``), with and
    without delta, against its plain version (s bitwise, n and rstd within
    ``NORM_TOL``); which side it is, from ``add_rms_norm_reads_once``."""
    dtype = getattr(torch, dtype_name)

    def make(scale):
        t = (torch.randn((3, d), generator=gen, device=dev) * scale).to(dtype)
        if offset:
            t = torch.empty(t.numel() + 1, dtype=dtype, device=dev)[1:].view(3, d).copy_(t)
        return t

    x, delta = make(2.0), make(1.0)
    once = E.add_rms_norm_reads_once(d, dtype, head=d if offset else 0)
    parts = []
    for dl in (delta, None):
        s, n, rstd = E.add_rms_norm_fwd(x, dl)
        want_s, want_n, want_r = E.add_rms_norm_plain(x, dl)
        torch.cuda.synchronize()
        if not torch.equal(s, want_s):
            raise AssertionError(f"add_rms_norm_fwd (3, {d}) {dtype_name}: s differs from x + delta")
        tag = "" if dl is None else "+delta "
        parts += [err_within(torch, f"{tag}n", n, want_n, E.NORM_TOL[dtype], errs),
                  err_within(torch, f"{tag}rstd", rstd, want_r, E.NORM_TOL[dtype], errs)]
    log(f"phase5 K4a (3, {d}) {dtype_name}{' one element off 16-byte alignment' if offset else ''}"
        f", {'read once (registers)' if once else 'read twice'}: " + "; ".join(parts))
    return once


def k4f_case(torch, E, gen, dev, shape, dtype, offset, errs, sp=1):
    """K4f against its plain versions on the same inputs, bit for bit: the
    forward with delta and without, and the gradient, over an sp ring of
    ``sp`` ranks. ``offset``: every input one element into a buffer, off
    16-byte alignment."""

    def make(scale):
        t = (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)
        if offset:
            t = torch.empty(t.numel() + 1, dtype=dtype, device=dev)[1:].view(shape).copy_(t)
        return t

    x, delta, g = make(2.0), make(1.0), make(1.0)
    label = f"K4f {tuple(shape)} {str(dtype)[6:]}" + (f" sp {sp}" if sp > 1 else "")
    fwd, bwd = errs["ring_mean_add_fwd"], errs["ring_mean_add_bwd"]
    parts = [hold(torch, label, "s2", E.ring_mean_add_fwd(x, delta, sp),
                  E.ring_mean_add_plain(x, delta, sp), None, fwd),
             hold(torch, label, "s2 without delta", E.ring_mean_add_fwd(x, None, sp),
                  E.ring_mean_add_plain(x, None, sp), None, fwd),
             hold(torch, label, "g_s", E.ring_mean_add_bwd(g, sp), E.ring_mean_add_bwd_plain(g, sp),
                  None, bwd)]
    log(f"phase5 {label}{' one element off 16-byte alignment' if offset else ''}: "
        + "; ".join(parts))


def k4f_bounds(b, t, d):
    """K4f's bounds at (b, t, d) in bf16: the forward reads x and delta and
    writes s2, three f32 operations an element (the add, the sum, the add);
    the gradient reads g and writes g_s, two (the sum, the add). The mean
    and the column sums stay on the chip."""
    n = b * t * d
    out = {}
    for name, streams, ops in (("ring_mean_add_fwd", 3, 3), ("ring_mean_add_bwd", 2, 2)):
        bound, by, _ = k3_bounds(ops * n, streams * 2 * n)
        out[name] = {"bytes": streams * 2 * n, "ops": ops * n, "bound_ms": bound,
                     "bound_by": by}
    return out


def k4f_timings(torch, E, gen, dev):
    """Device times (behind a spin kernel) of K4f at the bench_fabricnet
    width in bf16, (batch 4, seq 1024, d_model 2048), beside their bounds
    and their plain versions; no single PyTorch call computes either
    function."""
    shape = (BENCH_FABRICNET["batch"], BENCH_FABRICNET["seq"], BENCH_FABRICNET["d_model"])
    x, delta, g = ((torch.randn(shape, generator=gen, device=dev) * sc).to(torch.bfloat16)
                   for sc in (2.0, 1.0, 1.0))
    cases = {"ring_mean_add_fwd": (lambda: E.ring_mean_add_fwd(x, delta),
                                   lambda: E.ring_mean_add_plain(x, delta)),
             "ring_mean_add_bwd": (lambda: E.ring_mean_add_bwd(g),
                                   lambda: E.ring_mean_add_bwd_plain(g))}
    bounds = k4f_bounds(*shape)
    res = {}
    for name, (kern, plain) in cases.items():
        ms, queued = device_ms(torch, kern, 50)
        res[name] = {"ms": ms, "queued_in_time": queued, "plain_ms": device_ms(torch, plain, 10)[0],
                     "library_ms": None, "dtype": "bfloat16", "shape": list(shape), **bounds[name]}
    log("phase8 K4f timings at (4, 1024, 2048) bf16, device time behind a spin kernel: "
        + "; ".join(f"{name} {r['ms']:.6f} ms (bound {r['bound_ms']:.6f} by {r['bound_by']}, "
                    f"{r['bytes']} B, {100 * r['bound_ms'] / r['ms']:.1f} %; plain "
                    f"{r['plain_ms']:.6f}; library none"
                    + ("" if r["queued_in_time"] else "; host-bound") + ")"
                    for name, r in res.items()))
    return res


def k4f_sp_timings(torch, E, gen, dev):
    """K4f's sp form at phase 7d's heads = 0 stage input, (2, 1024, 2048)
    bf16 at sp 2, device time behind a spin kernel on inputs that arrive
    cold (the calls rotate over inputs that fill ``K4F_ROTATE_BYTES``, past
    the L2, as the step's do; ``delta_timings``' scheme), beside the one-rank
    form (sp 1) on the same rotation, the same kernel on one input again
    and again (``warm_ms``), the bound (x and delta read, s written; g read,
    g_s written) and the plain version; no PyTorch call computes it."""
    shape, sp = K4F_SP_SHAPE, K4F_SP
    n = math.prod(shape)
    per = math.ceil(K4F_ROTATE_BYTES / (2 * n))  # bf16 tensors in rotation
    xs = [(torch.randn(shape, generator=gen, device=dev) * 2.0).to(torch.bfloat16)
          for _ in range(per)]
    bounds = k4f_bounds(*shape)
    res = {}
    for name in K4F:
        if name == "ring_mean_add_fwd":
            pick = lambda i: (xs[i % per], xs[(i + 1) % per])  # noqa: E731
            kern = lambda a, s_: E.ring_mean_add_fwd(*a, s_)  # noqa: E731
            plain = lambda a: E.ring_mean_add_plain(*a, sp)  # noqa: E731
        else:
            pick = lambda i: (xs[i % per],)  # noqa: E731
            kern = lambda a, s_: E.ring_mean_add_bwd(*a, s_)  # noqa: E731
            plain = lambda a: E.ring_mean_add_bwd_plain(*a, sp)  # noqa: E731
        r = {}
        for key, s_ in (("ms", sp), ("sp1_ms", 1)):
            calls = iter(range(1 << 30))
            r[key], r["queued_in_time" if s_ == sp else "sp1_queued_in_time"] = device_ms(
                torch, lambda: kern(pick(next(calls)), s_), 50)
        r["warm_ms"] = device_ms(torch, lambda: kern(pick(0), sp), 50)[0]
        r["plain_ms"] = device_ms(torch, lambda: plain(pick(0)), 10)[0]
        res[name] = {**r, "library_ms": None, "dtype": "bfloat16", "shape": list(shape), "sp": sp,
                     "inputs_in_rotation": per, **bounds[name]}
    log(f"phase8 K4f's sp form at {shape} bf16, sp {sp}, device time behind a spin kernel, "
        f"inputs cold ({per} tensors in rotation) / warm: " + "; ".join(
            f"{name} {r['ms']:.6f} / {r['warm_ms']:.6f} ms (bound {r['bound_ms']:.6f} by "
            f"{r['bound_by']}, {r['bytes']} B, {100 * r['bound_ms'] / r['ms']:.1f} % cold; the "
            f"sp 1 form cold {r['sp1_ms']:.6f}; plain {r['plain_ms']:.6f}; library none"
            + ("" if r["queued_in_time"] else "; host-bound") + ")" for name, r in res.items()))
    return res


def k4_launches_per_step(cfg, pp=1):
    """K4 and K4f launches of one train step through ``pp`` stages, per
    microbatch and stage: K4a for the norm before each MLP layer, the
    attention block and the MoE; K4b for each of them but the first
    stage's first, whose input is the batch and takes no gradient; K4c and
    K4d for the GeLU of each MLP layer and of the MoE; with heads = 0, K4f's
    forward once, and its backward once but where no MLP layer comes before
    it in the first stage (its input is then the batch)."""
    m, layers = cfg.microbatches, cfg.layers_per_stage
    norms = layers + bool(cfg.heads) + 1
    ring = 0 if cfg.heads else m * pp
    return {"add_rms_norm_fwd": m * pp * norms, "rms_norm_bwd": m * (pp * norms - 1),
            "gelu_tanh_fwd": m * pp * (layers + 1), "gelu_tanh_bwd": m * pp * (layers + 1),
            "ring_mean_add_fwd": ring,
            "ring_mean_add_bwd": ring if layers else max(ring - m, 0)}


def k4_timings(torch, E, gen, dev):
    """Device times (behind a spin kernel) of K4 at the bench_fabricnet
    shapes in bf16, beside their bounds, their plain versions and the one
    PyTorch call that computes the same function, on the same tensors: the
    norms at (4096, 2048), the GeLUs at the MLP's (4096, 8192) and the
    MoE's (2, 2048, 2048); K4a also in f32."""
    import torch.nn.functional as F

    bf16 = torch.bfloat16
    rows, d = K4_SHAPES[0]
    x, delta, g_s, g_n = ((torch.randn((rows, d), generator=gen, device=dev) * sc).to(bf16)
                          for sc in (2.0, 1.0, 1.0, 1.0))
    s, _, rstd = E.add_rms_norm_fwd(x, delta)
    rms = getattr(F, "rms_norm", None)
    lib_fwd = lib_bwd = None
    if rms is not None:
        lib_fwd = lambda: rms(x, (d,), eps=1e-6)  # noqa: E731
        xg = x.detach().requires_grad_()
        yl = rms(xg, (d,), eps=1e-6)
        lib_bwd = lambda: torch.autograd.grad(yl, xg, g_n, retain_graph=True)  # noqa: E731
    nb = rows * d * 2
    cases = {
        # name: (kernel, plain, library, bytes: inputs read once, outputs written once, elements)
        "add_rms_norm_fwd": (lambda: E.add_rms_norm_fwd(x, delta),
                             lambda: E.add_rms_norm_plain(x, delta), lib_fwd,
                             4 * nb + 4 * rows, rows * d),
        "add_rms_norm_fwd nodelta": (lambda: E.add_rms_norm_fwd(x), lambda: E.add_rms_norm_plain(x),
                                     lib_fwd, 2 * nb + 4 * rows, rows * d),
        "rms_norm_bwd": (lambda: E.rms_norm_bwd(s, rstd, g_n, g_s),
                         lambda: E.rms_norm_bwd_plain(s, rstd, g_n, g_s), lib_bwd,
                         4 * nb + 4 * rows, rows * d),
    }
    # K4a in f32 at the same shape (the f32 train step's norms)
    x32, delta32 = (torch.randn((rows, d), generator=gen, device=dev) * sc for sc in (2.0, 1.0))
    lib32 = None if rms is None else (lambda: rms(x32, (d,), eps=1e-6))
    cases["add_rms_norm_fwd f32"] = (lambda: E.add_rms_norm_fwd(x32, delta32),
                                     lambda: E.add_rms_norm_plain(x32, delta32), lib32,
                                     8 * nb + 4 * rows, rows * d)
    cases["add_rms_norm_fwd nodelta f32"] = (lambda: E.add_rms_norm_fwd(x32),
                                             lambda: E.add_rms_norm_plain(x32), lib32,
                                             4 * nb + 4 * rows, rows * d)
    for shape in K4_SHAPES[1:]:
        h, dy = ((torch.randn(shape, generator=gen, device=dev) * sc).to(bf16) for sc in (2.0, 1.0))
        n = h.numel()
        tag = "" if shape == K4_SHAPES[1] else f" {tuple(shape)}"
        cases["gelu_tanh_fwd" + tag] = (
            lambda h=h: E.gelu_tanh_fwd(h), lambda h=h: E.gelu_plain(h),
            lambda h=h: F.gelu(h, approximate="tanh"), 4 * n, n)
        cases["gelu_tanh_bwd" + tag] = (
            lambda h=h, dy=dy: E.gelu_tanh_bwd(h, dy), lambda h=h, dy=dy: E.gelu_bwd_plain(h, dy),
            lambda h=h, dy=dy: torch.ops.aten.gelu_backward(dy, h, approximate="tanh"), 6 * n, n)
    res = {}
    for name, (kern, plain, lib, nbytes, elements) in cases.items():
        flops = K4_OPS_PER_ELEMENT[name.split()[0]] * elements
        bound, by, _ = k3_bounds(flops, nbytes)
        ms, queued = device_ms(torch, kern, 50)
        res[name] = {"ms": ms, "queued_in_time": queued,
                     "plain_ms": device_ms(torch, plain, 10)[0],
                     "library_ms": None if lib is None else device_ms(torch, lib, 50)[0],
                     "bound_ms": bound, "bound_by": by, "bytes": nbytes, "ops": flops}
    log("phase8 K4 timings, bf16 (K4a also f32), device time behind a spin kernel: " + "; ".join(
        f"{name} {r['ms']:.6f} ms (bound {r['bound_ms']:.6f} by {r['bound_by']}, "
        f"{100 * r['bound_ms'] / r['ms']:.1f} %; plain {r['plain_ms']:.6f}; library "
        + ("none" if r["library_ms"] is None else f"{r['library_ms']:.6f}")
        + ("" if r["queued_in_time"] else "; host-bound") + ")" for name, r in res.items()))
    return res


# -- K4e: the SGD update, the MoE's gate and combine, the loss (phases 5, 7, 7b, 8)


def same_bits(torch, a, b) -> bool:
    it = {torch.bfloat16: torch.int16, torch.float32: torch.int32}[a.dtype]
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.contiguous().view(it), b.contiguous().view(it)))


def k4e_launches_per_step(cfg, schedule="fused", shape=None):
    """K4e launches of one train step on a mesh of axis sizes ``shape``
    (None: one rank). ``"fused"``: one update over every leaf (one launch
    per 64 leaves), the loss once a data rank (dp x ep x sp) over its block
    of the whole batch, the MoE's combine forward and backward once a
    microbatch and stage. A sliced step of M slices: M - 1 updates (M - 2
    accumulations and the last slice's; the fused update when M = 1), and
    the combine and the loss once a slice (and stage, and data rank)."""
    from incubator_brpc_tpu_torch.ops.update import launches

    shape = shape or {}
    pp = shape.get("pp", 1)
    data = shape.get("dp", 1) * shape.get("ep", 1) * shape.get("sp", 1)
    m = cfg.microbatches
    # _weights' views: a stage's layers of w_in and w_out, moe_w1, moe_w2,
    # gate (and wqkv's three projections and wo), and the head
    leaves = pp * (2 * cfg.layers_per_stage + 3 + (4 if cfg.heads else 0)) + 1
    per_update = launches(leaves)
    return {"sgd_update_multi": per_update * (1 if schedule == "fused" else max(m - 1, 1)),
            "moe_combine_fwd": m * pp, "moe_combine_bwd": m * pp,
            "mse_loss_fwd": data * (1 if schedule == "fused" else m)}


def k3_launches_per_step(cfg, shape=None):
    """K3 launches of one bf16 train step on a mesh of axis sizes ``shape``:
    the tensor-core fold ``sp`` times a microbatch and stage (one hop of
    the ring each), delta, dK/dV and dQ once; none with heads = 0, and no
    f32 kernel."""
    shape = shape or {}
    pp, sp = shape.get("pp", 1), shape.get("sp", 1)
    per = cfg.microbatches * pp if cfg.heads else 0
    return {**dict.fromkeys(K3, 0), FOLD["bfloat16"]: per * sp, DKDV["bfloat16"]: per,
            DQ["bfloat16"]: per, "attn_bwd_delta": per}


def shifted(torch, values, off):
    """A copy of ``values`` ``off`` elements into a buffer of its own."""
    buf = torch.empty(values.numel() + off, dtype=values.dtype, device=values.device)
    return buf[off:].view(values.shape).copy_(values)


def k4e_update_case(torch, U, label, ps, gs, accs, lr, offsets=None):
    """K4e-a against its plain version on copies of one table, bit for bit,
    in each mode (the last slice of 2 and of 3 slices). ``offsets``: each
    leaf's (p, g, acc) elements into its buffer; the copies keep them."""
    offsets = offsets or [(0, 0, 0)] * len(ps)
    gs = [shifted(torch, g, o[1]) for g, o in zip(gs, offsets)]
    accs = [shifted(torch, a, o[2]) for a, o in zip(accs, offsets)]
    for mode, slices in (("fused", 1), ("accumulate", 1), ("last", 2), ("last", 3)):
        src = accs if mode == "accumulate" else ps
        k = 2 if mode == "accumulate" else 0
        got = [shifted(torch, t, o[k]) for t, o in zip(src, offsets)]
        want = [shifted(torch, t, o[k]) for t, o in zip(src, offsets)]
        acc = accs if mode == "last" else None
        U.sgd_update_multi(mode, got, gs, lr, acc=acc, slices=slices)
        for i, w in enumerate(want):
            U.sgd_update_plain(mode, w, gs[i], lr, None if acc is None else acc[i], slices)
        torch.cuda.synchronize()
        bad = [i for i, (a, b) in enumerate(zip(got, want)) if not same_bits(torch, a, b)]
        if bad:
            worst = max(int(ulps(torch, got[i], want[i]).max()) for i in bad)
            raise AssertionError(f"sgd_update_multi {label} {mode} (slices {slices}): leaves "
                                 f"{bad} differ from sgd_update_plain, at most {worst} ulps")
    return f"{label}: bitwise in fused, accumulate and last (2 and 3 slices)"


def k4e_update_cases(torch, U, fabricnet, gen, dev, dtype):
    """Phase 5's K4e-a tables in ``dtype``: the bench_fabricnet leaves, the
    mixed sizes and alignments of ``K4E_MIXED``, 70 leaves (two launches a
    call), and the crafted float32 element that a float64 sum would round
    twice."""
    from incubator_brpc_tpu_torch.ops import kernels

    name = str(dtype)[6:]
    rnd = lambda shape, sc: (torch.randn(shape, generator=gen, device=dev) * sc).to(dtype)  # noqa: E731
    cfg = fabricnet.FabricNetConfig(dtype=dtype, **BENCH_FABRICNET)
    params = fabricnet.init_params(cfg, fabricnet.make_fabric_mesh(1), generator=gen)
    ps = list(fabricnet._leaves(fabricnet._weights(params, cfg.heads)))
    parts = [k4e_update_case(torch, U, f"bench leaves ({len(ps)}, "
                                       f"{sum(p.numel() for p in ps)} elements)",
                             ps, [rnd(p.shape, 0.3) for p in ps], [rnd(p.shape, 0.3) for p in ps],
                             cfg.lr)]
    del params, ps
    sizes = [n for n, _ in K4E_MIXED]
    offs = [o for _, o in K4E_MIXED]
    mixed = [shifted(torch, rnd((n,), 1.0), o[0]) for n, o in zip(sizes, offs)]
    parts.append(k4e_update_case(torch, U, f"mixed leaves {sizes} at offsets {offs}", mixed,
                                 [rnd((n,), 0.3) for n in sizes], [rnd((n,), 0.3) for n in sizes],
                                 1e-2, offs))
    many = [rnd((n,), 1.0) for n in range(1, 71)]
    before = kernels.launch_counts()["sgd_update_multi"]
    parts.append(k4e_update_case(torch, U, "70 leaves", many, [rnd(p.shape, 0.3) for p in many],
                                 [rnd(p.shape, 0.3) for p in many], 1e-2))
    calls = kernels.launch_counts()["sgd_update_multi"] - before
    if calls != 4 * 2:
        raise AssertionError(f"sgd_update_multi on 70 leaves: {calls} launches in 4 calls, want 8")
    if dtype == torch.float32:
        p, g = (torch.tensor([v], device=dev) for v in CRAFTED)
        U.sgd_update_multi("fused", [p], [g], CRAFTED_LR)
        if float(p) != 1 + 2.0 ** -23:
            raise AssertionError(f"sgd_update_multi f32: {float(p)!r} where fmaf gives 1 + 2^-23")
        parts.append("the crafted element rounded once (1 + 2^-23)")
    log(f"phase5 K4e-a sgd_update_multi {name}: " + "; ".join(parts))


def hold(torch, label, tag, got, want, tol, errs, diff=None):
    """``err_within(tag, ...)`` with a float ``tol``; with ``tol`` None bit
    for bit: the outputs a kernel computes op for op as its plain version (a
    tolerance scaled by max(1, max |want|) would pass a wrong d_out, whose
    values lie near 1e-6); with an int ``tol``, bit for bit but for elements
    within that many ulps of their dtype (those that pass through the card's
    tanhf or expf), counted into ``diff`` by dtype as [differing, of]."""
    if isinstance(tol, float):
        return err_within(torch, tag, got, want, tol, errs)
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{label} {tag}: {got.dtype} {tuple(got.shape)}, "
                             f"want {want.dtype} {tuple(want.shape)}")
    errs[tag] = max(errs.get(tag, 0.0), float((got.float() - want.float()).abs().max()))
    it = {torch.bfloat16: torch.int16, torch.float32: torch.int32}[got.dtype]
    u = ulps(torch, got, want)
    differ = int((got.contiguous().view(it) != want.contiguous().view(it)).sum())
    worst = int(u.max()) if u.numel() else 0
    if diff is not None:
        prev = diff.get(str(got.dtype)[6:], [0, 0])
        diff[str(got.dtype)[6:]] = [prev[0] + differ, prev[1] + u.numel()]
    if (differ if tol is None else worst > tol):
        raise AssertionError(f"{label} {tag}: {differ} of {u.numel()} elements differ from the "
                             f"plain version (at most {worst} ulps), held bit for bit"
                             + (f" but for {tol} ulp" if tol else ""))
    return f"{tag} bitwise" if not differ else f"{tag} {differ} of {u.numel()} within {tol} ulp"


def k4e_case(torch, E, gen, dev, dtype, moe_shape, loss_shape, offset, errs, diffs):
    """K4e-b/c at ``moe_shape`` (t, e, d) and K4e-d at ``loss_shape``
    against their plain versions on the same inputs: d_yr, d_logit and d_out
    bit for bit, out and g bit for bit but for elements within
    ``TRANSCENDENTAL_ULPS`` (expf), the loss within ``MSE_TOL``, the
    differing elements counted into ``diffs``; K4e-d twice, bitwise the
    same. ``offset``: every input one element into a buffer."""

    def make(shape, scale):
        t = (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)
        return shifted(torch, t, 1) if offset else t

    def count(name, got, want):
        u = ulps(torch, got, want)
        prev = diffs.setdefault(name, [0, 0, 0])
        diffs[name] = [prev[0] + int((u > 0).sum()), prev[1] + u.numel(), max(prev[2], int(u.max()))]

    name = str(dtype)[6:]
    t, e, d = moe_shape
    s, yr, logit, dy = make((t, d), 1.0), make((e, t // e, d), 1.0), make((t, 1), 2.0), make((t, d), 1.0)
    out, g = E.moe_combine_fwd(s, yr, logit)
    want_out, want_g = E.moe_combine_plain(s, yr, logit)
    d_yr, d_logit = E.moe_combine_bwd(dy, yr, want_g)
    want_dyr, want_dlogit = E.moe_combine_bwd_plain(dy, yr, want_g)
    out_l, y = make(loss_shape, 1.0), make(loss_shape, 1.0)
    loss, d_out = E.mse_loss_fwd(out_l, y)
    again = E.mse_loss_fwd(out_l, y)[0]
    want_loss, want_dout = E.mse_loss_plain(out_l, y)
    torch.cuda.synchronize()
    if not same_bits(torch, loss, again):
        raise AssertionError(f"mse_loss_fwd {loss_shape} {name}: a rerun gave other bits")
    parts = []
    ulp = E.TRANSCENDENTAL_ULPS
    for kname, tag, got, want, tl in (  # tolerance None: bit for bit
            ("moe_combine_fwd", "out", out, want_out, ulp),
            ("moe_combine_fwd", "g", g, want_g, ulp),
            ("moe_combine_bwd", "d_yr", d_yr, want_dyr, None),
            ("moe_combine_bwd", "d_logit", d_logit, want_dlogit, None),
            ("mse_loss_fwd", "loss", loss, want_loss, E.MSE_TOL[dtype]),
            ("mse_loss_fwd", "d_out", d_out, want_dout, None)):
        count(f"{kname} {tag} {name}", got, want)
        parts.append(hold(torch, f"{kname} {tuple(got.shape)} {name}", tag, got, want, tl,
                          errs[kname]))
    log(f"phase5 K4e {name}{' one element off 16-byte alignment' if offset else ''}: combine "
        f"(t, e, d) {moe_shape}, loss {loss_shape}: " + "; ".join(parts)
        + "; the loss bitwise on a rerun")


def k4e_timings(torch, U, E, fabricnet, gen, dev):
    """Device times (behind a spin kernel) of K4e at the bench_fabricnet
    shapes in bf16, beside their bounds, their plain versions and, where
    one exists, a PyTorch call: ``torch._foreach_add_(ps, gs, alpha=-lr)``
    for the update (it rounds once, where the update rounds twice: not the
    same function) and ``F.mse_loss`` forward and backward for the loss."""
    import torch.nn.functional as F

    bf16 = torch.bfloat16
    cfg = fabricnet.FabricNetConfig(dtype=bf16, **BENCH_FABRICNET)
    params = fabricnet.init_params(cfg, fabricnet.make_fabric_mesh(1), generator=gen)
    ps = list(fabricnet._leaves(fabricnet._weights(params, cfg.heads)))
    gs, accs = ([(torch.randn(p.shape, generator=gen, device=dev) * 0.3).to(bf16) for p in ps]
                for _ in range(2))
    n = sum(p.numel() for p in ps)
    lr = cfg.lr
    t, e, d = K4E_MOE_SHAPES[0]
    rnd = lambda shape, sc: (torch.randn(shape, generator=gen, device=dev) * sc).to(bf16)  # noqa: E731
    s, yr, logit, dy = rnd((t, d), 1.0), rnd((e, t // e, d), 1.0), rnd((t, 1), 2.0), rnd((t, d), 1.0)
    _, g = E.moe_combine_fwd(s, yr, logit)
    out, y = rnd(K4E_LOSS_SHAPES[0], 1.0), rnd(K4E_LOSS_SHAPES[0], 1.0)
    og = out.detach().requires_grad_()
    nl = out.numel()

    def plain_sgd(mode, slices=1):
        tgt = accs if mode == "accumulate" else ps
        for i, p in enumerate(tgt):
            U.sgd_update_plain(mode, p, gs[i], lr, accs[i] if mode == "last" else None, slices)

    cases = {
        # name: (kernel, plain, library, bytes: inputs read once, outputs written once, ops)
        "sgd_update_multi": (lambda: U.sgd_update_multi("fused", ps, gs, lr),
                             lambda: plain_sgd("fused"),
                             lambda: torch._foreach_add_(ps, gs, alpha=-lr), 3 * 2 * n, 2 * n),
        "sgd_update_multi accumulate": (lambda: U.sgd_update_multi("accumulate", accs, gs),
                                        lambda: plain_sgd("accumulate"),
                                        lambda: torch._foreach_add_(accs, gs), 3 * 2 * n, n),
        "sgd_update_multi last": (lambda: U.sgd_update_multi("last", ps, gs, lr, acc=accs, slices=2),
                                  lambda: plain_sgd("last", 2), None, 4 * 2 * n, 4 * n),
        "moe_combine_fwd": (lambda: E.moe_combine_fwd(s, yr, logit),
                            lambda: E.moe_combine_plain(s, yr, logit), None,
                            (3 * t * d + 2 * t) * 2, 2 * t * d),
        "moe_combine_bwd": (lambda: E.moe_combine_bwd(dy, yr, g),
                            lambda: E.moe_combine_bwd_plain(dy, yr, g), None,
                            (3 * t * d + 2 * t) * 2, 3 * t * d),
        "mse_loss_fwd": (lambda: E.mse_loss_fwd(out, y), lambda: E.mse_loss_plain(out, y),
                         lambda: torch.autograd.grad(F.mse_loss(og, y), og),
                         3 * 2 * nl + 2, 6 * nl),
    }
    res = {}
    for name, (kern, plain, lib, nbytes, ops) in cases.items():
        bound, by, _ = k3_bounds(ops, nbytes)
        ms, queued = device_ms(torch, kern, 50)
        res[name] = {"ms": ms, "queued_in_time": queued,
                     "plain_ms": device_ms(torch, plain, 10)[0],
                     "library_ms": None if lib is None else device_ms(torch, lib, 50)[0],
                     "bound_ms": bound, "bound_by": by, "bytes": nbytes, "ops": ops}
    res["sgd_update_multi"].update(library="torch._foreach_add_(ps, gs, alpha=-lr): rounds once",
                                   leaves=len(ps), elements=n)
    # mse_loss_fwd is two kernels a launch: the pass and mse_loss_sum; the sum alone
    from incubator_brpc_tpu_torch.ops import kernels
    lib, st = kernels.build(), kernels._stream(out.device)
    blocks = lib.tb_mse_loss_blocks(nl, 1)
    partial = torch.randn(blocks, generator=gen, device=dev)
    loss = torch.empty((), dtype=bf16, device=dev)

    def loss_sum():
        if lib.tb_mse_loss_sum(partial.data_ptr(), blocks, loss.data_ptr(), nl, 1, st):
            raise AssertionError("tb_mse_loss_sum did not launch")

    res["mse_loss_fwd"].update(kernels_per_launch=2, sum_blocks=blocks,
                               sum_ms=device_ms(torch, loss_sum, 50)[0])
    log(f"phase8 K4e timings, bf16, device time behind a spin kernel (the update over the "
        f"{len(ps)} bench leaves, {n} elements; the combine at (t, e, d) {K4E_MOE_SHAPES[0]}; "
        f"the loss at {K4E_LOSS_SHAPES[0]}): " + "; ".join(
            f"{name} {r['ms']:.6f} ms (bound {r['bound_ms']:.6f} by {r['bound_by']}, "
            f"{100 * r['bound_ms'] / r['ms']:.1f} %; plain {r['plain_ms']:.6f}; library "
            + ("none" if r["library_ms"] is None else f"{r['library_ms']:.6f}")
            + ("" if r["queued_in_time"] else "; host-bound") + ")" for name, r in res.items())
        + "; the library call of sgd_update_multi is torch._foreach_add_(alpha=-lr), which "
        "rounds once (not the same function), of mse_loss_fwd F.mse_loss forward and backward; "
        f"mse_loss_fwd's second kernel, mse_loss_sum over {blocks} partials, alone "
        f"{res['mse_loss_fwd']['sum_ms']:.6f} ms")
    return res


def fabricnet_small_card_vs_cpu(torch, fabricnet, dev):
    """One fused train step on the card (kernels) and on the CPU (plain
    versions) from the same numpy weights and batch."""
    import numpy as np

    cfg = fabricnet.FabricNetConfig(d_model=32, d_ff=64, d_expert=32, layers_per_stage=2,
                                    batch=4, seq=32, microbatches=2, heads=2)
    rng = np.random.default_rng(20261017)
    shapes = fabricnet.param_shapes(cfg, fabricnet.make_fabric_mesh(1, device="cpu"))
    arrays = {k: (rng.standard_normal(shape) * scale).astype(np.float32)
              for k, (shape, scale) in shapes.items()}
    x, y = (rng.standard_normal((cfg.batch, cfg.seq, cfg.d_model)).astype(np.float32)
            for _ in range(2))
    got = {}
    for where in ("cpu", dev):
        params = fabricnet.params_from_numpy(arrays, cfg, where)
        step = fabricnet.make_train_step(cfg, device=where)
        params, loss = step(params, torch.from_numpy(x).to(where), torch.from_numpy(y).to(where))
        got[str(where)] = (float(loss), {k: p.cpu() for k, p in params.items()})
    (loss_cpu, p_cpu), (loss_card, p_card) = got["cpu"], got[str(dev)]
    # f32 on both sides; cuBLAS and the CPU sum in other orders
    if abs(loss_card - loss_cpu) > 1e-5 * abs(loss_cpu):
        raise AssertionError(f"FabricNet loss: card {loss_card}, cpu {loss_cpu}")
    worst = max(float((p_card[k] - p_cpu[k]).abs().max()) / float(p_cpu[k].abs().max())
                for k in p_cpu)
    if worst > 1e-5:
        raise AssertionError(f"FabricNet params: card and cpu differ by {worst} (relative)")
    log(f"phase6 FabricNet d_model 32, heads 2, two layers, f32, one train step: loss card "
        f"{loss_card} cpu {loss_cpu}; params differ by at most {worst:.3g} of their largest "
        f"value (tol 1e-5)")


def fabricnet_main_path(torch, fabricnet, kernels, dev, dtype, nsteps, warmup, heads=2):
    """The second main path: ``nsteps`` train steps at the bench_fabricnet
    width in ``dtype``, counted: each K3 kernel of that dtype's path once a
    step (``attn_bwd_delta`` in the form ``delta_form`` names), the other
    dtype's fold never; with ``heads = 0`` (phase 7c) no K3 kernel, and K4f
    once a step each way."""
    from incubator_brpc_tpu_torch.ops import attention

    cfg = fabricnet.FabricNetConfig(dtype=dtype, heads=heads, **BENCH_FABRICNET)
    phase = "phase7" if heads else "phase7c"
    mesh = fabricnet.make_fabric_mesh(1)
    gen = torch.Generator(device=mesh.device)
    gen.manual_seed(0)
    params = fabricnet.init_params(cfg, mesh, generator=gen)
    x, y = fabricnet.make_batch(cfg, mesh, generator=gen)
    step = fabricnet.make_train_step(cfg, mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()  # the parameters, the batch, and what else is alive
    kernels.reset_launch_counts()
    forms_before = attention.delta_form_counts()
    losses = []
    for i in range(nsteps):
        if i == warmup:
            t0 = time.perf_counter()
        params, loss = step(params, x, y)
        losses.append(float(loss))  # synchronizes
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / (nsteps - warmup) * 1e3
    launches = kernels.launch_counts()
    delta_forms = delta_forms_since(attention, forms_before)
    peak = torch.cuda.max_memory_allocated()
    want_forms = {attention.delta_form(cfg.d_model // heads, dtype, True): nsteps} if heads else {}
    if delta_forms != want_forms:
        raise AssertionError(f"FabricNet heads {heads}: attn_bwd_delta ran {delta_forms}; "
                             f"delta_form names {want_forms}")
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"FabricNet losses not finite and falling: {losses}")
    name = str(dtype)[6:]
    other = "float32" if name == "bfloat16" else "bfloat16"
    path = (FOLD[name], DKDV[name], DQ[name]) + K3_BOTH
    others = (FOLD[other], DKDV[other], DQ[other])
    per_step = {n: launches[n] / nsteps for n in K3}
    if not heads:
        path, others = (), K3
    if any(per_step[n] != 1 for n in path) or any(launches[n] for n in others) or any(
            launches.get(n, 0) for n in REMOVED):
        raise AssertionError(f"FabricNet {name} heads {heads}: K3 launches per step {per_step}; "
                             f"want one of each of {path}, none of {others + REMOVED}")
    k4_per_step = {n: launches[n] / nsteps for n in K4 + K4F}
    if k4_per_step != k4_launches_per_step(cfg):
        raise AssertionError(f"FabricNet {name}: K4 launches per step {k4_per_step}; want "
                             f"{k4_launches_per_step(cfg)}")
    k4e_per_step = {n: launches[n] / nsteps for n in K4E}
    if k4e_per_step != k4e_launches_per_step(cfg):
        raise AssertionError(f"FabricNet {name}: K4e launches per step {k4e_per_step}; want "
                             f"{k4e_launches_per_step(cfg)}")
    flops = fabricnet.train_step_flops(cfg)
    tflops = flops / ms * 1e-9
    log(f"{phase} FabricNet at the bench_fabricnet width ({BENCH_FABRICNET}, heads {cfg.heads}, "
        f"{name}), {nsteps} train steps: losses {losses}")
    log(f"{phase} {name} heads {cfg.heads} {ms:.3f} ms/step (host clock, steps {warmup + 1}-{nsteps}); "
        f"{flops / 1e12:.4f} TFLOP/step (3 x forward, attention without the causal skip); "
        f"{tflops:.2f} TFLOP/s = {100 * tflops / 989:.2f} % of 989 TFLOP/s bf16; "
        f"peak memory {peak} B ({peak / 2**30:.3f} GiB; {base} B allocated when the steps "
        f"began, so the steps' own {peak - base} B); launches {launches}; "
        f"K3 launches per step {per_step} (attn_bwd_delta's forms {delta_forms}); K4 and K4f "
        f"launches per step {k4_per_step}; K4e launches per step {k4e_per_step}")
    return {"ms_per_step": ms, "flops_per_step": flops, "tflops": tflops, "losses": losses,
            "peak_bytes": peak, "base_bytes": base, "launches": launches,
            "delta_forms": {f"{f} {lanes}": n for (f, lanes), n in delta_forms.items()},
            "nsteps": nsteps}, (step, params, x, y)


def fabricnet_sliced_path(torch, fabricnet, kernels, nsteps=10, reps=3):
    """Phase 7b: the sliced schedules at the ``bench_fabricnet_overlap``
    width (bf16, two slices), as ``bench.py:1002-1015`` runs them: a warm
    step each, then ``reps`` interleaved runs of ``nsteps`` chained steps
    from the same parameters (serialized first in even runs). Held: the
    chained losses and the final parameters byte-identical across the
    schedules and across runs, the losses finite and falling, the launches
    a step; reported: ms a step (best and mean), their difference, peak
    memory."""
    cfg = fabricnet.FabricNetConfig(dtype=torch.bfloat16, **BENCH_OVERLAP)
    mesh = fabricnet.make_fabric_mesh(1)
    gen = torch.Generator(device=mesh.device)
    gen.manual_seed(0)
    params0 = fabricnet.init_params(cfg, mesh, generator=gen)
    x, y = fabricnet.make_batch(cfg, mesh, generator=gen)
    names = ("serialized", "overlapped")
    steps = {s: fabricnet.make_train_step(cfg, mesh, schedule=s) for s in names}
    for s in names:  # the warm step
        steps[s]({k: v.clone() for k, v in params0.items()}, x, y)
    torch.cuda.synchronize()
    ms = {s: [] for s in names}
    losses, finals, launches, peak = {}, {}, {}, {}
    for rep in range(reps):
        for s in names if rep % 2 == 0 else names[::-1]:
            params = {k: v.clone() for k, v in params0.items()}
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            out = [steps[s](params, x, y)[1] for _ in range(nsteps)]
            torch.cuda.synchronize()
            ms[s].append((time.perf_counter() - t0) / nsteps * 1e3)
            chain = torch.stack(out).cpu()
            if chain.dtype != torch.float32:
                raise AssertionError(f"{s}: loss {chain.dtype}, want float32")
            if rep == 0:  # on the host, out of the next run's peak memory
                losses[s], finals[s] = chain, {k: v.cpu() for k, v in params.items()}
                launches[s] = kernels.launch_counts()
                peak[s] = (torch.cuda.max_memory_allocated(), base)
            elif not same_bits(torch, chain, losses[s]) or not all(
                    same_bits(torch, params[k].cpu(), finals[s][k]) for k in params):
                raise AssertionError(f"{s}: run {rep} differs from run 0")
            del params
    ser, ovl = losses["serialized"], losses["overlapped"]
    if not same_bits(torch, ser, ovl) or not all(
            same_bits(torch, finals["serialized"][k], finals["overlapped"][k]) for k in params0):
        raise AssertionError("the sliced schedules' losses or parameters differ")
    chain = ser.tolist()
    if not all(map(math.isfinite, chain)) or not chain[-1] < chain[0]:
        raise AssertionError(f"sliced schedules: losses not finite and falling: {chain}")
    m = cfg.microbatches
    want = {**{n: m for n in (FOLD["bfloat16"], DKDV["bfloat16"], DQ["bfloat16"]) + K3_BOTH},
            **{n: 0 for n in K3_F32}, **k4_launches_per_step(cfg),
            **k4e_launches_per_step(cfg, "serialized")}
    for s in names:
        got = {n: launches[s][n] / nsteps for n in want}
        if got != want:
            raise AssertionError(f"{s}: launches per step {got}; want {want}")
    best = {s: min(v) for s, v in ms.items()}
    log(f"phase7b sliced schedules at the bench_fabricnet_overlap width ({BENCH_OVERLAP}, "
        f"heads {cfg.heads}, bfloat16), {nsteps} chained steps after a warm step, {reps} runs "
        f"interleaved: losses {chain} (f32, byte-identical across the schedules and the runs; "
        f"final parameters byte-identical)")
    log(f"phase7b ms/step (host clock) serialized {ms['serialized']} (best "
        f"{best['serialized']:.3f}), overlapped {ms['overlapped']} (best "
        f"{best['overlapped']:.3f}); overlapped - serialized {best['overlapped'] - best['serialized']:.3f} "
        f"ms; peak memory (peak, allocated when the steps began) {peak} B, so the steps' own "
        f"{ {s: p - b for s, (p, b) in peak.items()} } B; launches per step {want} (each schedule)")
    return {"ms_per_step": ms, "best_ms_per_step": best, "losses": chain,
            "peak_bytes": peak, "launches_per_step": want}


def fabricnet_heads0_path(torch, fabricnet, kernels, E, dev):
    """Phase 7c: the train step with heads = 0 (the ring mean, K4f, in place
    of ring attention) at the bench_fabricnet width in bf16, counted as
    ``fabricnet_main_path`` counts it, after 2 warm-up steps; then device
    time over two profiled steps, and the same with K4f's plain versions in
    its autograd function, device time only, as a record."""
    fab, train = fabricnet_main_path(torch, fabricnet, kernels, dev, torch.bfloat16, 10, 2,
                                     heads=0)
    fab["profile"] = profile_steps(torch, train, "heads 0 bf16", "phase7c")
    saved = E.ring_mean_add_fwd, E.ring_mean_add_bwd
    E.ring_mean_add_fwd, E.ring_mean_add_bwd = E.ring_mean_add_plain, E.ring_mean_add_bwd_plain
    try:
        fab["plain_k4f_profile"] = profile_steps(
            torch, train, "heads 0 bf16 with K4f's plain versions", "phase7c")
    finally:
        E.ring_mean_add_fwd, E.ring_mean_add_bwd = saved
    return fab


class patched:
    """Inside, each ``(module, name, function)`` of ``patches`` replaces
    ``module.name``; outside, as before."""

    def __init__(self, patches):
        self.patches = patches

    def __enter__(self):
        self.saved = [(m, n, getattr(m, n)) for m, n, _ in self.patches]
        for m, n, f in self.patches:
            setattr(m, n, f)
        return self

    def __exit__(self, *exc):
        for m, n, f in self.saved:
            setattr(m, n, f)
        return False


class plain_versions(patched):
    """Inside, every kernel of the FabricNet step runs its plain PyTorch
    version on the card instead: the wrappers' module names patched (K3's
    fold and backward, K4, K4e, K4f), as a record to hold the kernels'
    step against. Outside, as before."""

    def __init__(self):
        from incubator_brpc_tpu_torch.models import fabricnet
        from incubator_brpc_tpu_torch.ops import attention as A
        from incubator_brpc_tpu_torch.ops import elementwise as E
        from incubator_brpc_tpu_torch.ops import update as U

        def fold(q, k, v, state, *, hop, sp, causal, finalize):
            m, l, o = A.fold_plain(q, k, v, state, hop=hop, sp=sp, causal=causal)
            out, lse = A.finalize_plain((m, l, o), q.dtype) if finalize else (None, None)
            return m, l, o, out, lse

        def sgd(mode, targets, grads, lr=0.0, acc=None, slices=1):
            for i, p in enumerate(targets):
                U.sgd_update_plain(mode, p, grads[i], lr, None if acc is None else acc[i], slices)

        super().__init__([
            (A, "fold", fold), (A, "row_dot", A.row_dot_plain), (A, "dkdv", A.dkdv_plain),
            (A, "dq", A.dq_plain), (E, "add_rms_norm_fwd", E.add_rms_norm_plain),
            (E, "rms_norm_bwd", E.rms_norm_bwd_plain), (E, "gelu_tanh_fwd", E.gelu_plain),
            (E, "gelu_tanh_bwd", E.gelu_bwd_plain), (E, "moe_combine_fwd", E.moe_combine_plain),
            (E, "moe_combine_bwd", E.moe_combine_bwd_plain),
            (E, "ring_mean_add_fwd", E.ring_mean_add_plain),
            (E, "ring_mean_add_bwd", E.ring_mean_add_bwd_plain),
            (fabricnet, "mse_loss_fwd", E.mse_loss_plain), (fabricnet, "sgd_update_multi", sgd)])


class recorded_gradients(patched):
    """Inside, FabricNet's update (the kernel's wrapper, or whatever stands
    in its place) first keeps a copy of the gradients it is handed, one
    list a call, in ``self.grads``."""

    def __init__(self):
        from incubator_brpc_tpu_torch.models import fabricnet

        self.grads = kept = []  # not self in the closure: no cycle keeps the gradients
        update = fabricnet.sgd_update_multi

        def record(mode, targets, grads, *args, **kw):
            kept.append([g.clone() for g in grads])
            return update(mode, targets, grads, *args, **kw)

        super().__init__([(fabricnet, "sgd_update_multi", record)])


def planted_faults(heads):
    """``{name: patches}``: faults a backward kernel could make, each a
    wrapper's result off by 1% (K4b's gradient; K3's dQ with heads, K4f's
    ring-mean term without), for phase 7d to show that its gradient check
    refuses them."""
    from incubator_brpc_tpu_torch.ops import attention as A
    from incubator_brpc_tpu_torch.ops import elementwise as E

    scaled = lambda f: lambda *a, **k: f(*a, **k) * 1.01  # noqa: E731
    faults = {"rms_norm_bwd x 1.01": [(E, "rms_norm_bwd", scaled(E.rms_norm_bwd))]}
    if heads:
        faults["dq x 1.01"] = [(A, "dq", scaled(A.dq))]
    else:
        ring_bwd = E.ring_mean_add_bwd
        faults["ring_mean_add_bwd's mean term x 1.01"] = [
            (E, "ring_mean_add_bwd", lambda g, sp=1: g + (ring_bwd(g, sp) - g) * 1.01)]
    return faults


def leaf_names(views):
    """The names of ``fabricnet._leaves(views)``, in its order."""
    for p, stage in enumerate(views["stages"]):
        for k, v in stage.items():
            if isinstance(v, list):
                yield from (f"{k}[{p}][{i}]" for i in range(len(v)))
            else:
                yield f"{k}[{p}]"
    yield "head"


def gradient_errors(torch, got, want, names):
    """``{reading: (leaf, value)}``, the worst leaf of each reading of the
    difference ``d = got - want`` against the plain gradient ``g = want``:
    ``largest``, max |d| over max |g|; ``norm``, the 2-norm of d over g's;
    ``bias``, |<d, g>| / <g, g>, the part of d along g. A kernel off by a
    factor moves ``bias`` by that factor; rounding in another order, which
    does not follow g, barely moves it."""
    worst = {}
    for n, a, b in zip(names, got, want):
        d, g = a.double() - b.double(), b.double()
        gg = max(1e-300, float((g * g).sum()))
        readings = {"largest": float(d.abs().max()) / max(1e-300, float(g.abs().max())),
                    "norm": math.sqrt(float((d * d).sum()) / gg),
                    "bias": abs(float((d * g).sum())) / gg}
        for k, v in readings.items():
            if k not in worst or v > worst[k][1]:
                worst[k] = (n, v)
    return worst


def mesh_step_check(torch, fabricnet, cfg, mesh, params0, x, y):
    """One fused step with the kernels against the same step with the plain
    versions, from ``params0``: the losses (the forward), the gradients the
    update is handed (every backward kernel; ``gradient_errors``), and the
    kernels' updated parameters against the plain update applied to the
    kernels' gradients, bit for bit. Then each of ``planted_faults`` in the
    kernels' step, its gradient error beside the plain step's. Returns the
    readings; the caller holds them to its tolerances."""
    from incubator_brpc_tpu_torch.ops import update as U

    step = fabricnet.make_train_step(cfg, mesh)
    copy = lambda: {k: v.clone() for k, v in params0.items()}  # noqa: E731
    names = list(leaf_names(fabricnet._weights(params0, cfg.heads)))
    pk, pp_ = copy(), copy()
    with recorded_gradients() as rk:
        loss_k = float(step(pk, x, y)[1])
    with plain_versions(), recorded_gradients() as rp:
        loss_p = float(step(pp_, x, y)[1])
    gk, gp = rk.grads[0], rp.grads[0]
    want = copy()
    for p, g in zip(fabricnet._leaves(fabricnet._weights(want, cfg.heads)), gk):
        U.sgd_update_plain("fused", p, g, cfg.lr)
    update_exact = all(same_bits(torch, pk[k], want[k]) for k in want)
    r = {"loss_kernels": loss_k, "loss_plain": loss_p, "update_exact": update_exact,
         "gradients": gradient_errors(torch, gk, gp, names), "faults": {}}
    del pk, pp_, want, gk, rk
    for fault, patches in planted_faults(cfg.heads).items():
        with patched(patches), recorded_gradients() as rf:
            step(copy(), x, y)
        r["faults"][fault] = gradient_errors(torch, rf.grads[0], gp, names)
        del rf
    return r


def hold_mesh_step(r, label, loss_rtol, grad_tol):
    """Raise unless ``mesh_step_check``'s readings ``r`` hold: the loss
    within ``loss_rtol``, every leaf's gradient within ``grad_tol`` (a
    bound for each of ``gradient_errors``' readings), the update bit for
    bit, and every planted fault refused (some reading above its bound)."""
    if not abs(r["loss_kernels"] - r["loss_plain"]) <= loss_rtol * abs(r["loss_plain"]):
        raise AssertionError(f"{label}: loss {r['loss_kernels']} with the kernels, "
                             f"{r['loss_plain']} with the plain versions (rtol {loss_rtol})")
    over = {k: v for k, v in r["gradients"].items() if not v[1] <= grad_tol[k]}
    if over:
        raise AssertionError(f"{label}: gradients off the plain versions' {over} "
                             f"(tol {grad_tol})")
    if not r["update_exact"]:
        raise AssertionError(f"{label}: the step's update differs from the plain update of "
                             "its gradients")
    passed = {f: e for f, e in r["faults"].items()
              if all(v[1] <= grad_tol[k] for k, v in e.items())}
    if passed:
        raise AssertionError(f"{label}: planted faults within the gradient tolerances "
                             f"{grad_tol}: {passed}")


def mesh_step_tols(torch, dtype):
    """``(loss_rtol, grad_tol)`` of ``hold_mesh_step`` for ``dtype``."""
    if dtype == torch.bfloat16:
        return MESH_LOSS_RTOL, MESH_GRAD_TOL
    return MESH_SMALL_F32_TOL, dict.fromkeys(MESH_GRAD_TOL, MESH_SMALL_F32_TOL)


def small_mesh_checks(torch, fabricnet, device=None):
    """``mesh_step_check`` at ``MESH_SMALL`` on {pp2 sp2 ep2}, heads 2 and
    0, bf16 and f32, each held by ``hold_mesh_step``: ``{label: readings}``."""
    out = {}
    for heads in (2, 0):
        for dtype in (torch.bfloat16, torch.float32):
            cfg = fabricnet.FabricNetConfig(heads=heads, dtype=dtype, **MESH_SMALL)
            mesh = fabricnet.make_fabric_mesh(8, axis_sizes={"pp": 2, "sp": 2, "ep": 2},
                                              device=device)
            params0 = fabricnet.init_params(cfg, mesh, seed=21)
            x, y = fabricnet.make_batch(cfg, mesh, seed=22)
            label = f"small {{pp2 sp2 ep2}} heads {heads} {str(dtype).split('.')[-1]}"
            out[label] = mesh_step_check(torch, fabricnet, cfg, mesh, params0, x, y)
            hold_mesh_step(out[label], label, *mesh_step_tols(torch, dtype))
    return out


def fabricnet_mesh_path(torch, fabricnet, kernels, nsteps=MESH_STEPS):
    """Phase 7d: FabricNet's bf16 train step at the bench_fabricnet_overlap
    width on ``MESH_RUNS``, all 8 ranks of each mesh on the card. For each:
    one fused step with the kernels against the same step with the plain
    versions from the same parameters (``mesh_step_check``, held by
    ``hold_mesh_step``: the loss, every leaf's gradient, the update bit for
    bit, and planted faults refused); then ``nsteps``
    chained fused steps with the launch counts set to 0 (the loss finite and
    falling, every launch a step asserted: K3's fold ``sp`` times a
    microbatch and stage, K4f once each way a stage with heads = 0, K4e-a
    once a step), ms a step on the host clock after the first, peak memory,
    and the device time of two profiled steps; on C, the forward against the
    one-rank forward of the same parameters and batch; on B, the sliced
    schedules, serialized against overlapped, byte for byte."""
    out, launches_by_run = {}, {}
    one_rank = None
    for name, axes, heads, lr in MESH_RUNS:
        label = f"{name} {{{' '.join(f'{a}{n}' for a, n in axes.items())}}} heads {heads}"
        cfg = fabricnet.FabricNetConfig(dtype=torch.bfloat16, heads=heads, lr=lr, **BENCH_OVERLAP)
        mesh = fabricnet.make_fabric_mesh(8, axis_sizes=axes)
        shape = mesh.shape
        gen = torch.Generator(device=mesh.device)
        gen.manual_seed(7)
        params0 = fabricnet.init_params(cfg, mesh, generator=gen)
        x, y = fabricnet.make_batch(cfg, mesh, generator=gen)
        step = fabricnet.make_train_step(cfg, mesh)
        copy = lambda: {k: v.clone() for k, v in params0.items()}  # noqa: E731
        r = {"axes": axes, "heads": heads, "lr": lr,
             "parameters": sum(v.numel() for v in params0.values()),
             "flops_per_step": fabricnet.train_step_flops(cfg, shape["pp"])}
        # (2) the kernels' step against the plain versions' from the same parameters
        check = mesh_step_check(torch, fabricnet, cfg, mesh, params0, x, y)
        r["against_plain"] = check
        hold_mesh_step(check, f"phase7d {label}", MESH_LOSS_RTOL, MESH_GRAD_TOL)
        # (1), (5): chained fused steps, counted
        params = copy()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        kernels.reset_launch_counts()
        losses = []
        for i in range(nsteps):
            if i == 1:
                t0 = time.perf_counter()
            losses.append(float(step(params, x, y)[1]))  # synchronizes
        ms = (time.perf_counter() - t0) / (nsteps - 1) * 1e3
        launches = kernels.launch_counts()
        r.update(losses=losses, ms_per_step=ms, peak_bytes=torch.cuda.max_memory_allocated(),
                 base_bytes=base, launches=launches, nsteps=nsteps)
        if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"phase7d {label}: losses not finite and falling: {losses}")
        want = {**k3_launches_per_step(cfg, shape), **k4_launches_per_step(cfg, shape["pp"]),
                **k4e_launches_per_step(cfg, "fused", shape)}
        got = {n: launches[n] / nsteps for n in want}
        if got != want:
            raise AssertionError(f"phase7d {label}: launches a step {got}; want {want}")
        r["launches_per_step"] = want
        launches_by_run[f"{name} heads {heads}"] = {n: launches[n] for n in want}
        r["profile"] = profile_steps(torch, (step, params, x, y), f"{label} bf16", "phase7d")
        log(f"phase7d {label}: {r['parameters']} parameters; kernels' step against the plain "
            f"versions' on the card: loss {check['loss_kernels']} / {check['loss_plain']} (rtol "
            f"{MESH_LOSS_RTOL}), the gradients' worst leaves {check['gradients']} (tol "
            f"{MESH_GRAD_TOL}), the update bit for bit, planted faults refused {check['faults']}; "
            f"{nsteps} fused steps: losses {losses}; "
            f"{ms:.3f} ms a step (host clock, steps 2-{nsteps}); peak memory {r['peak_bytes']} B "
            f"({r['base_bytes']} B allocated when the steps began); launches a step {want}")
        # (3) C's forward against the one-rank forward
        if name == "C":
            if one_rank is None:
                one_rank = fabricnet.make_fabric_mesh(1)
            fwd8 = fabricnet.make_forward_step(cfg, mesh)(params0, x).float()
            fwd1 = fabricnet.make_forward_step(cfg, one_rank)(params0, x).float()
            err = float((fwd8 - fwd1).abs().max()) / max(1.0, float(fwd1.abs().max()))
            differ = int((fwd8 != fwd1).sum())
            r.update(forward_vs_one_rank=err, forward_differing=[differ, fwd1.numel()])
            if not err <= MESH_FORWARD_TOL:
                raise AssertionError(f"phase7d {label}: forward against the one-rank forward "
                                     f"{err} of the largest value (tol {MESH_FORWARD_TOL})")
            log(f"phase7d {label}: forward against the one-rank forward of the same parameters "
                f"and batch within {err:.4g} of max(1, max |one-rank|) (tol {MESH_FORWARD_TOL}); "
                f"{differ} of {fwd1.numel()} outputs differ")
            del fwd8, fwd1
        # (4) B: the sliced schedules, byte for byte
        if name == "B":
            chains = {}
            for schedule in ("serialized", "overlapped"):
                sliced = fabricnet.make_train_step(cfg, mesh, schedule=schedule)
                ps = copy()
                t1 = time.perf_counter()
                ls = [sliced(ps, x, y)[1] for _ in range(2)]
                torch.cuda.synchronize()
                r[f"{schedule}_ms_per_step"] = (time.perf_counter() - t1) / 2 * 1e3
                chains[schedule] = (torch.stack(ls).cpu(), {k: v.cpu() for k, v in ps.items()})
                del ps
            (ls, ps), (lo, po) = chains["serialized"], chains["overlapped"]
            if not same_bits(torch, ls, lo) or not all(same_bits(torch, ps[k], po[k]) for k in ps):
                raise AssertionError(f"phase7d {label}: serialized and overlapped differ")
            r["sliced_losses"] = ls.tolist()
            log(f"phase7d {label}: serialized and overlapped, 2 chained steps: losses "
                f"{ls.tolist()} (f32) and parameters byte-identical; ms a step (host clock, "
                f"the first compiles nothing) {r['serialized_ms_per_step']:.3f} / "
                f"{r['overlapped_ms_per_step']:.3f}")
        out[f"{name} heads {heads}"] = r
        del params, params0, x, y
        gc.collect()
        torch.cuda.empty_cache()
    small = small_mesh_checks(torch, fabricnet)
    for label, check in small.items():
        log(f"phase7d {label}: kernels' step against the plain versions': loss "
            f"{check['loss_kernels']} / {check['loss_plain']}, the gradients' worst leaves "
            f"{check['gradients']}, the update bit for bit, planted faults refused {check['faults']}")
    out["small"] = small
    return out, launches_by_run


def profile_steps(torch, train, label="bf16", phase="phase8"):
    """torch.profiler over two train steps: device time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    step, params, x, y = train
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            params, loss = step(params, x, y)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kern = [e for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")]
    dev_us = lambda e: getattr(e, "self_device_time_total", None) or getattr(  # noqa: E731
        e, "self_cuda_time_total", 0)
    total = sum(dev_us(e) for e in kern)
    if not total:
        log(f"{phase} profile of {label} steps: the profiler saw no device time (not measured)")
        return None
    groups = {}
    for e in kern:
        name = e.key
        g = ("K3" if "attn_" in name else
             "K4e" if any(k in name for k in ("sgd_update_multi", "moe_combine", "mse_loss")) else
             "K4" if any(k in name for k in K4 + (K4F_KERNEL,)) else
             "matmul" if any(s in name.lower() for s in ("gemm", "nvjet", "xmma", "cutlass")) else
             "PyTorch elementwise and copies")
        groups[g] = groups.get(g, 0.0) + dev_us(e)
    top = sorted(kern, key=dev_us, reverse=True)[:12]
    log(f"{phase} profile of 2 {label} train steps: wall {wall_us:.1f} us, device busy {total:.1f} us "
        f"({100 * total / wall_us:.1f} %, idle {100 - 100 * total / wall_us:.1f} %); by group "
        + ", ".join(f"{g} {v:.1f} us ({100 * v / total:.1f} %)" for g, v in sorted(groups.items())))
    for e in top:
        log(f"  {dev_us(e):12.1f} us  x{e.count:<4d} {e.key[:110]}")
    return {"wall_us": wall_us, "device_us": total, "groups": groups}


def run_k3_phases(torch, kernels, dev):
    from incubator_brpc_tpu_torch.models import fabricnet, ring_attention
    from incubator_brpc_tpu_torch.ops import attention, elementwise, update

    # the plain versions' einsums in full f32, as the kernels compute
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev)
    gen.manual_seed(1017)
    errs = {name: {} for name in K3}

    # -- phase 5: K3 against its plain versions, and the ring against full ---
    # the bench shape at sp 1 and 4; T/sp = 12 at D 16; T/sp = 100 at D 144,
    # ragged against the tensor-core kernels' tiles and their 128-column D
    # chunks; T/sp = 36 at D 24 and D 20, off the tensor cores' k-step of 16
    # (D 20 with 8-byte rows), and D 18, which the wrappers pad to 20
    shapes = [BENCH_ATTN + (1,), BENCH_ATTN + (4,), (2, 48, 4, 16, 4), (1, 200, 2, 144, 2),
              (2, 72, 2, 24, 2), (2, 72, 2, 20, 2), (2, 72, 2, 18, 2)]
    for shape in shapes:
        for dtype in (torch.bfloat16, torch.float32):
            for causal in (True, False):
                k3_case(torch, attention, gen, dev, shape, dtype, causal, errs)
    for dtype in (torch.bfloat16, torch.float32):
        k3_layout_case(torch, attention, gen, dev, (2, 96, 2, 136, 2), dtype, errs)
        for d in DELTA_DS:
            delta_case(torch, attention, gen, dev, d, dtype, errs["attn_bwd_delta"])
    for (b, t, h, d, sp), dtype, tol in ((BENCH_ATTN + (4,), torch.bfloat16, 0.05),
                                          ((2, 48, 4, 16, 4), torch.float32, 2e-5)):
        q, k, v = (torch.randn((b, t, h, d), generator=gen, device=dev).to(dtype)
                   for _ in range(3))
        step, place = ring_attention.make_ring_attention_step(sp)
        got = step(place(q), place(k), place(v))
        want = ring_attention.full_attention(q, k, v)
        err = float((got.float() - want.float()).abs().max())
        if got.dtype != dtype or not err <= tol:
            raise AssertionError(f"ring_attention vs full_attention: {got.dtype}, err {err}")
        log(f"phase5 ring_attention vs full_attention on the card, B={b} T={t} H={h} D={d} "
            f"sp={sp} {str(dtype)[6:]}: max abs err {err:.3g} (tol {tol})")
    max_err = {name: max(e.values()) for name, e in errs.items()}
    log(f"phase5 K3 max_abs_err {max_err}")
    k4_errs, gelu_diff = {name: {} for name in K4}, {}
    for dtype in (torch.bfloat16, torch.float32):
        for shape, offset in [(shape, False) for shape in K4_SHAPES] + K4_ODD:
            k4_case(torch, elementwise, gen, dev, shape, dtype, offset, k4_errs, gelu_diff)
    sides = [k4a_cap_case(torch, elementwise, gen, dev, t, d, off, k4_errs["add_rms_norm_fwd"])
             for t, d, off in K4A_CAP]
    if sides != [True, False] * (len(K4A_CAP) // 2):
        raise AssertionError(f"K4A_CAP does not straddle the register cap: {sides}")
    k4_max_err = {name: max(e.values()) for name, e in k4_errs.items()}
    log(f"phase5 K4 max_abs_err {k4_max_err}; K4c and K4d elements differing from their plain "
        f"versions (differing, of; each within {elementwise.TRANSCENDENTAL_ULPS} ulp): {gelu_diff}")
    k4e_errs, k4e_diff = {name: {} for name in K4E}, {}
    for dtype in (torch.bfloat16, torch.float32):
        k4e_update_cases(torch, update, fabricnet, gen, dev, dtype)
        cases = [(m, l, False) for m, l in zip(K4E_MOE_SHAPES, K4E_LOSS_SHAPES)]
        for moe_shape, loss_shape, offset in cases + [(m, l, True) for m, l, _ in cases[2:]]:
            k4e_case(torch, elementwise, gen, dev, dtype, moe_shape, loss_shape, offset,
                     k4e_errs, k4e_diff)
    k4e_max_err = {name: max(e.values(), default=0.0) for name, e in k4e_errs.items()}
    log(f"phase5 K4e max_abs_err {k4e_max_err} (sgd_update_multi bitwise); elements differing "
        f"from the plain versions (differing, of, most ulps): {k4e_diff}")
    k4f_errs = {name: {} for name in K4F}
    for dtype in (torch.bfloat16, torch.float32):
        for shape, offset in K4F_CASES:
            k4f_case(torch, elementwise, gen, dev, shape, dtype, offset, k4f_errs)
    for dtype in (torch.bfloat16, torch.float32):
        for shape, offset, sp in K4F_SP_CASES:
            k4f_case(torch, elementwise, gen, dev, shape, dtype, offset, k4f_errs, sp)
    k4f_max_err = {name: max(e.values()) for name, e in k4f_errs.items()}
    log(f"phase5 K4f max_abs_err {k4f_max_err} (bit for bit its plain versions, sp 1 and the "
        f"sp form)")

    # -- phase 6: FabricNet on the card against the port on the CPU -----------
    fabricnet_small_card_vs_cpu(torch, fabricnet, dev)

    # -- phase 7: the FabricNet main path, counted: bf16 (the bench's dtype),
    # then f32, the path of the 3xTF32 fold, dK/dV and dQ ---------------------
    fab, train = fabricnet_main_path(torch, fabricnet, kernels, dev, torch.bfloat16, 10, 2)
    fab32, train32 = fabricnet_main_path(torch, fabricnet, kernels, dev, torch.float32, 3, 1)

    # -- phase 7b: the sliced schedules, counted --------------------------------
    sliced = fabricnet_sliced_path(torch, fabricnet, kernels)

    # -- phase 7c: heads = 0, the ring mean (K4f), counted ------------------------
    fab0 = fabricnet_heads0_path(torch, fabricnet, kernels, elementwise, dev)
    # -- phase 7d: the fabric mesh, all 8 ranks on the card, counted -------------
    mesh_runs, mesh_launches = fabricnet_mesh_path(torch, fabricnet, kernels)
    # the f32 path's kernels count the f32 steps' launches, K4f the heads = 0 steps'
    launches = dict(fab["launches"], **{n: fab32["launches"][n] for n in K3_F32},
                    **{n: fab0["launches"][n] for n in K4F})

    # -- phase 8: K3 and K4 timings, and the profile -----------------------
    timings = {sp: k3_timings(torch, attention, gen, dev, sp) for sp in (1, 4)}
    timings[1].update(k3_f32_timings(torch, attention, gen, dev))
    delta = delta_timings(torch, attention, gen, dev)
    k4 = k4_timings(torch, elementwise, gen, dev)
    k4f = k4f_timings(torch, elementwise, gen, dev)
    k4f_sp = k4f_sp_timings(torch, elementwise, gen, dev)
    k4e = k4e_timings(torch, update, elementwise, fabricnet, gen, dev)
    fab["profile"] = profile_steps(torch, train)
    fab32["profile"] = profile_steps(torch, train32, "f32")
    main = timings[1]  # FabricNet's sp = 1
    line = {}
    for name in K3:
        r = delta["bfloat16"] if name == "attn_bwd_delta" else main[name]
        line[name] = {
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
            "tensor_core_bound_ms": r.get("tensor_core_bound_ms"),
            "shape": list(BENCH_ATTN), "sp": 1, "dtype": "bfloat16",
        }
        if name == "attn_bwd_delta":  # the main path's forms, and both forms timed
            line[name].update(
                forms=fab["delta_forms"], f32_forms=fab32["delta_forms"],
                **{k: r[k] for k in ("general_ms", "warm_ms", "host_ms", "input_pairs", "copy_ms")},
                f32={k: delta["float32"][k] for k in ("form", "ms", "general_ms", "warm_ms",
                                                      "host_ms", "plain_ms", "bound_ms",
                                                      "library_ms")})
        if name in K3_F32:  # the f32 path's launches, timed in f32
            line[name].update(dtype="float32", **{k: r[k] for k in (
                "library_ms", "f32_fma_bound_ms", "backward_ms", "sdpa_backward_ms") if k in r})
            continue
        if name in (FOLD["bfloat16"], DKDV["bfloat16"], DQ["bfloat16"]):
            line[name]["sp4_ms"] = timings[4][name]["ms"]
            line[name]["sp4_bound_ms"] = timings[4][name]["bound_ms"]
        if name == "attn_fold_fwd_tc":
            line[name]["library_ms"] = main["sdpa_fwd_ms"]
            line[name]["b1_ms"] = main["fold_b1_ms"]
        else:
            line[name]["backward_ms"] = main["backward"]["ms"]
            line[name]["sdpa_backward_ms"] = main["sdpa_fwd_bwd_ms"] - main["sdpa_fwd_ms"]
    for name in K4:
        r = k4[name]
        line[name] = {k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
        line[name].update(dtype="bfloat16", shape=list(K4_SHAPES[name.startswith("gelu")]))
        max_err[name] = k4_max_err[name]
    line["add_rms_norm_fwd"].update(
        nodelta_ms=k4["add_rms_norm_fwd nodelta"]["ms"],
        nodelta_bound_ms=k4["add_rms_norm_fwd nodelta"]["bound_ms"],
        f32_ms=k4["add_rms_norm_fwd f32"]["ms"],
        f32_nodelta_ms=k4["add_rms_norm_fwd nodelta f32"]["ms"],
        f32_library_ms=k4["add_rms_norm_fwd f32"]["library_ms"])
    moe = f" {K4_SHAPES[2]}"
    for name in ("gelu_tanh_fwd", "gelu_tanh_bwd"):
        line[name]["moe_shape_ms"] = k4[name + moe]["ms"]
    for name in ("gelu_tanh_fwd", "gelu_tanh_bwd"):
        line[name]["differing_elements"] = gelu_diff[name]
    # the nearest PyTorch calls round once where the reference rounds op by op
    for name, call in (("rms_norm_bwd", "F.rms_norm's autograd backward"),
                       ("gelu_tanh_fwd", 'F.gelu(approximate="tanh")'),
                       ("gelu_tanh_bwd", 'aten.gelu_backward(approximate="tanh")')):
        line[name]["library"] = f"{call}: rounds once, not the same function in bf16"
    for name in K4E:
        r = k4e[name]
        line[name] = {k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
        line[name]["dtype"] = "bfloat16"
        line[name]["differing_elements"] = {k: v for k, v in k4e_diff.items() if k.startswith(name)}
        max_err[name] = k4e_max_err[name]
    line["sgd_update_multi"].update(
        leaves=k4e["sgd_update_multi"]["leaves"], accumulate_ms=k4e["sgd_update_multi accumulate"]["ms"],
        last_ms=k4e["sgd_update_multi last"]["ms"],
        last_bound_ms=k4e["sgd_update_multi last"]["bound_ms"],
        library=k4e["sgd_update_multi"]["library"])
    for name in K4F:
        line[name] = {k: k4f[name][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                 "library_ms", "dtype", "shape")}
        max_err[name] = k4f_max_err[name]
        line[name]["sp_form"] = {k: k4f_sp[name][k] for k in (
            "ms", "sp1_ms", "warm_ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape",
            "sp", "inputs_in_rotation")}
    for name in K3 + K4 + K4E + K4F:  # phase 7d's launches over its fused steps, a run each
        line[name]["mesh_launches"] = {run: n[name] for run, n in mesh_launches.items()}
    line["moe_combine_fwd"]["shape"] = line["moe_combine_bwd"]["shape"] = list(K4E_MOE_SHAPES[0])
    line["mse_loss_fwd"].update(shape=list(K4E_LOSS_SHAPES[0]), kernels_per_launch=2,
                                sum_ms=k4e["mse_loss_fwd"]["sum_ms"])
    return {"launches": launches, "max_err": max_err, "line": line,
            "detail": {**{f"sp{sp}": t for sp, t in timings.items()}, "delta": delta, "k4": k4,
                       "k4e": k4e, "k4f": k4f, "k4f_sp": k4f_sp},
            "fabricnet": fab, "fabricnet_f32": fab32, "fabricnet_sliced": sliced,
            "fabricnet_heads0": fab0, "fabricnet_mesh": mesh_runs}


# -- K2 and the quantized collective sessions (phases 9-11) --------------------


def u8(torch, t):
    """A tensor's bytes on the host, ``[rows, row bytes]``."""
    t = t.detach().contiguous()
    return t.view(torch.uint8).cpu().numpy().reshape(t.shape[0], -1)


def k2_layout(torch, rows: np.ndarray, dev, layout: str):
    """``rows`` on the card as K2a sees them: ``"contiguous"``; ``"offset"``,
    every row one float past a 16-byte boundary; ``"stride"``, rows on a
    16-byte boundary at a row stride of nfloats + 1 but for the first;
    ``"chunk<j>"``, chunk j of 4 column chunks of rows 4 x nfloats wide, as
    a chunked session cuts its state (``mc_dispatch._make_chunk_ops``)."""
    parties, nfloats = rows.shape
    if layout == "contiguous":
        return torch.from_numpy(rows).to(dev)
    if layout.startswith("chunk"):
        j = int(layout[len("chunk"):])
        buf = torch.zeros((parties, 4 * nfloats), dtype=torch.float32, device=dev)
        x = buf[:, j * nfloats:(j + 1) * nfloats]
        x.copy_(torch.from_numpy(rows).to(dev))
        return x
    pad, at = (4, 1) if layout == "offset" else (1, 0)
    buf = torch.zeros((parties, nfloats + pad), dtype=torch.float32, device=dev)
    x = buf[:, at:at + nfloats]
    x.copy_(torch.from_numpy(rows).to(dev))
    return x


def k2_forms(quantize, before) -> dict:
    """The forms launched since ``before`` (``quantize.form_counts()``):
    {kernel: [form, ...]} in the order of ``quantize.FORMS``."""
    after = quantize.form_counts()
    ran = {}
    for (name, form), n in after.items():
        if n > before.get((name, form), 0):
            ran.setdefault(name, []).append(form)
    return ran


def k2_case(torch, quantize, Q, dev, parties, width, block, mode, layout="contiguous"):
    """K2a and K2b (and K2b's dequantize and its one-row form, ``out_rows=1``)
    against the plain versions and
    the numpy twin, bitwise, on rows that carry the edge blocks, in the
    ``layout`` of ``k2_layout`` (``"offset"`` also hands K2b its q one byte
    past a 4-byte boundary); and one quantized pmean step of noise rows
    within pmean_error_bound. Returns the forms each kernel ran."""
    nfloats = width // 4
    rows = quant_rows(parties, nfloats, block, mode, seed=parties * 100 + block)
    x = k2_layout(torch, rows, dev, layout)
    before = quantize.form_counts()
    q, e = quantize.quantize_rows(x, mode, block)
    qk = q
    if layout == "offset":  # q one byte into a contiguous buffer
        qbuf = torch.empty(q.numel() + 1, dtype=q.dtype, device=dev)
        qk = qbuf[1:].view(q.shape)
        qk.copy_(q)
    got = {"q": q, "e": e, "mean": quantize.dequant_mean_rows(qk, e, mode, block),
           "mean1": quantize.dequant_mean_rows(qk, e, mode, block, out_rows=1),
           "dequantize": quantize.dequant_mean_rows(qk, e, mode, block, mean=False)}
    forms = k2_forms(quantize, before)
    qp, ep = quantize.quantize_rows_plain(x, mode, block)
    plain = {"q": qp, "e": ep, "mean": quantize.dequant_mean_rows_plain(qp, ep, mode, block),
             "mean1": quantize.dequant_mean_rows_plain(qp, ep, mode, block, out_rows=1),
             "dequantize": quantize.dequantize_rows_plain(qp, ep, mode, block)}
    if got["mean1"].shape != (1, nfloats):
        raise AssertionError(f"K2b out_rows=1 gave {tuple(got['mean1'].shape)}")
    got = {k: u8(torch, t) for k, t in got.items()}
    where = f"K2 {mode} P={parties} W={width} block={block} {layout}"
    for k, t in plain.items():
        if not np.array_equal(got[k], u8(torch, t)):
            raise AssertionError(f"{where}: {k} differs from the plain version")
    with np.errstate(over="ignore"):  # the FLT_MAX edge block dequantizes to +inf
        twins = [Q.np_quantize(r, mode, block) for r in rows]
        deqs = [Q.np_dequantize(tq, te, mode, block) for tq, te in twins]
        mean = np.sum(np.stack(deqs), axis=0, dtype=np.float32) / np.float32(parties)
    for r, (tq, te) in enumerate(twins):
        if (got["q"][r].tobytes() != tq.tobytes() or got["e"][r].tobytes() != te.tobytes()
                or got["dequantize"][r].tobytes() != deqs[r].tobytes()
                or got["mean"][r].tobytes() != mean.tobytes()):
            raise AssertionError(f"{where}: row {r} differs from the numpy twin")
    if got["mean1"][0].tobytes() != mean.tobytes():
        raise AssertionError(f"{where}: the one-row mean (out_rows=1) differs from the numpy twin")
    noise = quant_rows(parties, nfloats, block, mode, seed=parties + 7, edges=False)
    m = quantize.dequant_mean_rows(*quantize.quantize_rows(torch.from_numpy(noise).to(dev),
                                                           mode, block), mode, block)
    err = float(np.abs(m[0].cpu().numpy() - np.mean(noise, axis=0, dtype=np.float32)).max())
    bound = Q.pmean_error_bound(list(noise), 1, mode, block)
    if not err <= bound:
        raise AssertionError(f"{where}: quantized pmean error {err} > bound {bound}")
    e_seen = sorted(set(got["e"][:, :8].view(np.int8).reshape(-1).tolist()))
    log(f"phase9 {where}: forms {forms}; kernels (K2b's one-row form out_rows=1 too) bitwise "
        f"equal to the plain versions and the "
        f"numpy twin (exponents of the edge blocks {e_seen}); one pmean step of noise rows off "
        f"the exact mean by {err:.4g} <= bound {bound:.4g}")
    return forms


def session_rows(name, parties, width):
    if name == "bench":  # bench.py _mc_quantized_child's operands
        rng = np.random.default_rng(11)
        return np.stack([(rng.standard_normal(width // 4) * (i + 1)).astype(np.float32)
                         for i in range(parties)])
    return quant_rows(parties, width // 4, 32, "int8", seed=2026, edges=False)


def run_sessions(torch, kernels, mcd, mcc, Q, DeviceMethod, worker):
    """Phase 10: the session path through run_dispatch_session, with each
    session's K2 launches held to steps x chunks (+1 K2a per checkpoint).
    Returns (the quantized sessions' checks, each geometry's rows by mode)."""
    checked, rows_by = {}, {}

    def session(dm, ops, steps, want_k2, **kw):
        before = kernels.launch_counts()
        row, n, el = mcd.run_dispatch_session(list(range(len(ops))), 0, dm, ops, steps, **kw)
        after = kernels.launch_counts()
        got = tuple(after[k] - before[k] for k in K2)
        if got != want_k2:
            raise AssertionError(f"session {kw}: K2 launches {got}, want {want_k2}")
        return bytes(row[:n]), el

    for name, (parties, width, steps) in SESSIONS.items():
        rows = session_rows(name, parties, width)
        ops = [r.tobytes() for r in rows]
        dm = mcc._pmean_dm(width)
        kw = dict(service=mcc.PMEAN_SERVICE, method=mcc.PMEAN_METHOD)
        exact, bases = None, {}
        for mode in ("none", "int8", "int4"):
            outs = []
            for chunks, db in SCHEDULES:
                k = 0 if mode == "none" else steps * chunks
                outs.append(session(dm, ops, steps, (k, k), quantize=mode, chunks=chunks,
                                    double_buffer=db, **kw)[0])
            if any(o != outs[0] for o in outs):
                raise AssertionError(f"{name} {mode}: schedules differ from chunks=1")
            bases[mode] = outs[0]
            f = np.frombuffer(outs[0], np.float32)
            if mode == "none":
                exact = f
                if f.tobytes() != worker.pmean_model(rows, steps).tobytes():
                    raise AssertionError(f"{name}: exact session differs from the f32 model")
                log(f"phase10 {name} ({parties} parties x {width} B x {steps} steps) none: "
                    f"schedules {SCHEDULES} byte-identical; bitwise the party-ordered f32 mean")
                continue
            err = float(np.abs(f - exact).max())
            bound = Q.pmean_error_bound(list(rows), steps, mode)
            model = Q.np_quantized_pmean(list(rows), steps, mode)
            dev_model = float(np.abs(f - model).max())
            if not err <= bound or not dev_model <= 1e-5:
                raise AssertionError(f"{name} {mode}: err {err} (bound {bound}), "
                                     f"vs np_quantized_pmean {dev_model}")
            checked[(name, mode)] = {"err": err, "bound": bound,
                                     "model_bitwise": f.tobytes() == model.tobytes()}
            log(f"phase10 {name} {mode}: schedules byte-identical, K2 launches steps x chunks "
                f"each; off the exact session by {err:.4g} <= bound {bound:.4g}; vs "
                f"np_quantized_pmean max {dev_model:.3g} (bitwise "
                f"{checked[(name, mode)]['model_bitwise']})")
        # the integer kernel: byte for byte with its host model
        rng = np.random.default_rng(parties)
        iops = [rng.integers(0, 256, width - 8 * i, dtype=np.uint8).tobytes()
                for i in range(parties)]
        sdm = DeviceMethod(worker._scale_psum_kernel, width=width, chunkable=True)
        want = worker.session_expected(iops, steps, width)[0]
        for chunks, db in SCHEDULES:
            if session(sdm, iops, steps, (0, 0), chunks=chunks, double_buffer=db)[0] != want:
                raise AssertionError(f"{name}: _scale_psum_kernel chunks={chunks} db={db}")
        log(f"phase10 {name}: _scale_psum_kernel sessions equal session_expected byte for byte "
            f"under {SCHEDULES}")
        # a checkpointed quantized session, resumed from step 8
        for mode in ("int8", "int4"):
            for chunks in (1, 4):
                sid = f"smoke-{name}-{mode}-{chunks}"
                every, resume = 4, 8
                k = steps * chunks
                full, _ = session(dm, ops, steps, (k + steps // every, k), quantize=mode,
                                  session_id=sid, checkpoint_every=every, chunks=chunks, **kw)
                retained = mcd.checkpoint_bytes_retained()
                k = (steps - resume) * chunks
                again, _ = session(dm.quantized(mode), ops, steps,
                                   (k + (steps - resume) // every, k), session_id=sid,
                                   resume_from=resume, checkpoint_every=every, chunks=chunks, **kw)
                mcd.release_checkpoints(sid)
                if not again == full == bases[mode]:
                    raise AssertionError(f"{name} {mode} chunks={chunks}: resume from step "
                                         f"{resume} is not byte-identical")
            log(f"phase10 {name} {mode}: checkpoint_every {every}, resume_from {resume} "
                f"byte-identical to the undisturbed {steps} steps at chunks 1 and 4 "
                f"(ring held {retained} B)")
        rows_by[name] = bases
    return checked, rows_by


# -- phase 10b: the session plane over RPC, in one process and across ---------

PLANE_PARTIES = 8  # (a): phase 11's 8 x 1 MiB, one in-process server a party
PLANE_WIDTH = 1 << 20  # the JAX package's MAX_WIDTH, 1 MiB a party
PLANE_STEPS = 16
PLANE_RUNS = [("none", 1, False), ("int8", 1, False), ("int4", 1, False), ("int8", 4, True)]
PLANE_MC = dict(n_parties=3, steps=16, width=1 << 20)  # (b), one party a process
PLANE_CHAOS = dict(n_parties=3, steps=8, kill_at=3, checkpoint_every=2)  # (c)
PLANE_TIMEOUT_S = 240.0
PLANE_GATHER_ITERS = 20


def plane_k2_per_session(parties, steps, chunks, mode):
    """K2a (and K2b) launches of one quantized in-process session over RPC:
    each of the ``parties`` handlers computes the whole session (the
    single-controller form), one launch a step and chunk; 0 exact."""
    return 0 if mode == "none" else parties * steps * chunks


def session_plane_phase(torch, kernels, device="cuda:0", bases=None, parties=PLANE_PARTIES,
                        width=PLANE_WIDTH, steps=PLANE_STEPS, mc_session=PLANE_MC,
                        chaos=PLANE_CHAOS):
    """Phase 10b, the collective session plane over RPC: (a) in one process,
    ``parties`` servers on ``device`` with the collective services, a
    pure-scheduler proposer calling ``propose_dispatch`` over TCP channels
    (``PLANE_RUNS``), each session's rows byte for byte ``bases`` (phase
    10's ``run_dispatch_session`` rows, where given) and its model, its K2
    launches ``plane_k2_per_session``; (b) across processes,
    ``mc_worker.orchestrate_session`` (one party a rank, every process on
    ``device``, gloo): the user kernel, then exact, int8 and int4 pmean
    sessions, each checked by the client against its model byte for byte,
    each process's K2 launches held; the fingerprint-mismatch run, refused
    before any step; (c) the chaos drill, healed byte-identically. Returns
    (detail, K2 launches of (a), K2 launches of (b) summed over the
    processes). ``device="cpu"`` rehearses it at a small size
    (tests/test_torch_mc_session.py), where no kernel launches."""
    import concurrent.futures

    from incubator_brpc_tpu_torch import rpc
    from incubator_brpc_tpu_torch.parallel import mc_collective as mcc
    from incubator_brpc_tpu_torch.parallel import mc_dispatch as mcd
    from incubator_brpc_tpu_torch.parallel import quantized as Q
    from incubator_brpc_tpu_torch.rpc.device_method import (
        register_device_method,
        unregister_device_method,
    )
    from incubator_brpc_tpu_torch.transport import mc_worker as mc

    on_card = device != "cpu"
    out = {}
    rows = session_rows("full", parties, width)
    ops = [r.tobytes() for r in rows]
    want = {"none": mc.pmean_model(rows, steps).tobytes()}
    for mode in ("int8", "int4"):
        want[mode] = Q.np_quantized_pmean(list(rows), steps, mode).tobytes()

    # (a) in one process, counted; the proposer resolves the method in its
    # own registry (the servers' resolver mints it per width)
    register_device_method(mcc.PMEAN_SERVICE, mcc.PMEAN_METHOD, mcc._pmean_dm(width))
    servers = []
    try:
        for _ in range(parties):
            srv = rpc.Server(rpc.ServerOptions(device=device, enable_collective_service=True,
                                               collective_max_concurrency=0))
            if not srv.start(0):
                raise AssertionError("phase10b (a): a server did not start")
            servers.append(srv)
        chans = []
        for srv in servers:
            chans.append(rpc.Channel())
            chans[-1].init(f"127.0.0.1:{srv.port}")
        kernels.reset_launch_counts()
        runs = []
        for mode, chunks, db in PLANE_RUNS:
            before = kernels.launch_counts()
            t0 = time.perf_counter()
            res = mcd.propose_dispatch(chans, list(range(parties)), mcc.PMEAN_SERVICE,
                                       mcc.PMEAN_METHOD, ops, steps=steps, proposer_index=None,
                                       timeout_ms=600_000, quantize=mode, chunks=chunks,
                                       double_buffer=db)
            wall = time.perf_counter() - t0
            after = kernels.launch_counts()
            got = tuple(after[k] - before[k] for k in K2)
            k = plane_k2_per_session(parties, steps, chunks, mode) if on_card else 0
            if got != (k, k):
                raise AssertionError(f"phase10b (a) {mode} chunks={chunks}: K2 launches {got}, "
                                     f"want {(k, k)}")
            if any(r != want[mode] for r in res["results"]):
                raise AssertionError(f"phase10b (a) {mode} chunks={chunks}: a party's row is not "
                                     "its model's")
            if bases is not None and res["results"][0] != bases[mode]:
                raise AssertionError(f"phase10b (a) {mode}: differs from phase 10's session")
            rec = {"mode": mode, "chunks": chunks, "double_buffer": db, "wall_s": wall,
                   "ms_per_step": wall / steps * 1e3,
                   "party_ms_per_step": [e / steps * 1e3 for e in res["party_elapsed_s"]],
                   "k2": got}
            runs.append(rec)
            log(f"phase10b (a) {parties} in-process servers on {device}, {parties} x {width} B x "
                f"{steps} steps, {mode} chunks={chunks} double_buffer={db}: every party's row "
                f"bitwise its model"
                + (" and phase 10's session" if bases is not None else "")
                + f"; {rec['ms_per_step']:.3f} ms a step at the proposer (proposals of "
                f"{parties * width / 2**20:g} MiB to each server included), each handler's chain "
                f"{min(rec['party_ms_per_step']):.3f}-{max(rec['party_ms_per_step']):.3f} ms a "
                f"step; K2 {got} (each handler computes the whole session)")
        launches_a = {name: kernels.launch_counts()[name] for name in K2}
    finally:
        unregister_device_method(mcc.PMEAN_SERVICE, mcc.PMEAN_METHOD)
        for srv in servers:
            srv.stop()
            srv.join(timeout=60)
        rpc.shutdown_host_plane()
    out["in_process"] = runs

    # (b) across processes, one party a rank, counted in each process
    dev = dict(device=device, backend="gloo", timeout=PLANE_TIMEOUT_S)
    t0 = time.perf_counter()
    # rpcz is on in the processes for the traced session alone: the
    # sessions before it run rpcz off, as phase 10b ran them before
    st, transcript = mc.orchestrate_session(quantize="int8,int4", traced=True, **mc_session, **dev)
    out["across_s"] = time.perf_counter() - t0
    pm = st["pmean"]
    if not all(r["bitwise_model"] for r in pm.values()):
        raise AssertionError(f"phase10b (b): a pmean session missed its model\n{transcript}")
    n, k_steps = mc_session["n_parties"], mc_session["steps"]
    per_proc = {"client": st["k2_launches"],
                **{name: rec["k2_launches"] for name, rec in st["servers"].items()}}
    _trace, t_steps, t_chunks = mc.TRACED_SESSION
    # int8 and int4, one launch a step each, and the traced int8 session's
    # one a step and chunk
    want_k = 2 * k_steps + t_steps * t_chunks if on_card else 0
    for name, got in per_proc.items():
        if got != {"quantize_rows": want_k, "dequant_mean_rows": want_k}:
            raise AssertionError(f"phase10b (b) {name}: K2 launches {got}, want {want_k} each")
    launches_b = {k: sum(p[k] for p in per_proc.values()) for k in K2}
    tr = st["traced"]
    if tr["k2"] != ({"quantize_rows": t_steps * t_chunks, "dequant_mean_rows": t_steps * t_chunks}
                    if on_card else {"quantize_rows": 0, "dequant_mean_rows": 0}):
        raise AssertionError(f"phase10b (b) traced session: the client's K2 launches {tr['k2']}")
    out["traced"] = tr
    log(f"phase10b (b) the traced int8 session ({n} processes, {t_steps} steps, chunks={t_chunks} "
        f"double-buffered), proposed inside a caller's traced handler: trace {tr['trace_id']}, "
        f"{tr['spans']} spans from the {n} processes {tr['spans_by_process']}, {tr['counts']}, one "
        f"tree under the caller's span; {tr['ms_per_step']:.3f} ms a step; the tree:")
    for line in tr["tree"]:
        depth = (len(line) - len(line.lstrip(" "))) // 2
        parts = line.split()
        note = line.split("annotations=", 1)[1][:70] if "annotations=[(" in line else ""
        log("    " + "  " * depth + f"{parts[3]} {parts[4]} {note}")
    out["across"] = st
    log(f"phase10b (b) {n} processes on {device} over gloo, one party a rank, {width} B x "
        f"{k_steps} steps: dsvc.scale bitwise session_expected, "
        f"{st['per_step_ms']:.3f} ms a step (parties "
        + ", ".join(f"{v:.3f}" for v in st["party_ms_per_step"])
        + f"; all_gather {st['gather_ms_per_step']:.3f} ms of it at the client); "
        + "; ".join(f"{m} pmean {r['ms_per_step']:.3f} ms a step (all_gather "
                    f"{r['gather_ms_per_step']:.3f} ms, {r['gathers'] // k_steps} a step"
                    + (f"; wire {r['wire_ratio']:.4f} of f32; err {r['max_error']:.3g} <= "
                       f"{r['error_bound']:.3g}" if m != "none" else "")
                    + ")" for m, r in pm.items())
        + f"; rows bitwise their models; K2 {per_proc}; {out['across_s']:.1f} s with the "
        "processes' start")

    # gloo's all_gather alone, on the session's group shape (every rank a
    # party): each row size a session step gathers, on the card (gloo
    # stages it) and on the host; the first gather on the group apart
    sizes = (width, 4 * width, Q.wire_bytes(width, "int8") - width // 128,
             Q.wire_bytes(width, "int4") - width // 128, width // 128)
    probe = mc.orchestrate_probe(axis=True, axis_bytes=sizes, iters=PLANE_GATHER_ITERS,
                                 nprocs=mc_session["n_parties"], words=(256,), **dev)
    out["gather_probe"] = probe
    log(f"phase10b (b) gloo's all_gather alone, {mc_session['n_parties']} processes (rank 0): "
        + "; ".join(f"{k} B: first {v['first_ms']:.3f} ms, then {v['ms']:.3f} ms"
                    for k, v in probe[0]["axis"].items() if isinstance(v, dict)))

    # the fingerprint reject and (c) the chaos drill, side by side (neither
    # is timed)
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        rej_f = pool.submit(mc.orchestrate_session, n_parties=mc_session["n_parties"], steps=4,
                            wrong_kernel=True, width=mc_session["width"], **dev)
        chaos_f = pool.submit(mc.orchestrate_chaos_session, width=mc_session["width"], **chaos,
                              **dev)
        rej, _ = rej_f.result()
        drill, drill_transcript = chaos_f.result()
    if not rej.get("rejected") or rej["sessions_run"] or any(
            r["gathers"] for r in rej["servers"].values()):
        raise AssertionError(f"phase10b (b) fingerprint mismatch: {rej}")
    out["reject"] = rej
    log("phase10b (b) a server with a same-name kernel of another body: the accept phase "
        "refused with a fingerprint mismatch, no session ran, no party gathered")
    if not (drill["byte_identical"] and drill["replaced_party_ids"] and drill["dead_party_ids"]
            and "SERVER_DYING" in drill_transcript):
        raise AssertionError(f"phase10b (c) chaos drill: {drill}")
    out["chaos"] = drill
    log(f"phase10b (c) chaos drill ({chaos}): party {drill['dead_party_ids']} killed at step "
        f"{chaos['kill_at']}, healed by {drill['replaced_party_ids']}, resumed_from "
        f"{drill['resumed_from']}, every row bitwise the undisturbed model")
    return out, launches_a, launches_b


# phase 11's timed K2 functions: (name in the detail, kernel, mean)
K2_TIMED = (("quantize_rows", "quantize_rows", None), ("dequant_mean_rows", "dequant_mean_rows", True),
            ("dequant_mean_rows mean=False", "dequant_mean_rows", False))


def k2_timings(torch, quantize, dev):
    """Phase 11: K2 at the full width, 3, 8 and 64 parties, int8 and int4,
    K2b's ``mean=False`` form, its one-row form (``out_rows=1``, the row a
    rank keeps in a session across processes; where the tree has it) and a
    session step's K2 (K2b, then K2a of its
    output), with CUDA events behind a spin kernel beside the bound (the
    bytes in and out over HBM) and the plain versions, and the wrapper's
    time back to back (host_ms); beside K2b, ``fill_`` of its output alone.
    The 8-party input (8 MiB) stays in the 50 MB L2 across the timed calls;
    the 64-party one does not."""
    res = {}
    form_of = getattr(quantize, "quantize_form", None)  # absent from trees before the vector forms
    dform_of = getattr(quantize, "dequant_form", None)
    one_row = "out_rows" in inspect.signature(quantize.dequant_mean_rows).parameters
    for parties, width in ((3, 1 << 20), (8, 1 << 20), (64, 1 << 20)):
        nfloats = width // 4
        x = torch.from_numpy(quant_rows(parties, nfloats, 32, "int8", seed=3, edges=False)).to(dev)
        for mode in ("int8", "int4"):
            q, e = quantize.quantize_rows(x, mode, 32)
            qbytes = q.numel() * q.element_size() + e.numel()
            xbytes = x.numel() * 4
            forms = {"quantize_rows": form_of(x, 32) if form_of else "n/a",
                     "dequant_mean_rows": dform_of(q, mode, 32) if dform_of else "n/a"}
            cases = {
                "quantize_rows": (lambda: quantize.quantize_rows(x, mode, 32),
                                  lambda: quantize.quantize_rows_plain(x, mode, 32),
                                  xbytes + qbytes, 4 * x.numel()),
                "dequant_mean_rows": (lambda: quantize.dequant_mean_rows(q, e, mode, 32),
                                      lambda: quantize.dequant_mean_rows_plain(q, e, mode, 32),
                                      qbytes + xbytes, 2 * x.numel() + nfloats),
                "dequant_mean_rows mean=False": (
                    lambda: quantize.dequant_mean_rows(q, e, mode, 32, mean=False),
                    lambda: quantize.dequant_mean_rows_plain(q, e, mode, 32, mean=False),
                    qbytes + xbytes, x.numel()),
                # the one row a rank keeps in a session across processes
                # (absent from trees before the one-row form)
                "dequant_mean_rows out_rows=1": (
                    lambda: quantize.dequant_mean_rows(q, e, mode, 32, out_rows=1),
                    lambda: quantize.dequant_mean_rows_plain(q, e, mode, 32, out_rows=1),
                    qbytes + 4 * nfloats, 2 * x.numel() + nfloats),
                # a session step's K2 on the card: the mean, then the next step's
                # quantize of it, which may find it in the L2
                "step": (lambda: quantize.quantize_rows(quantize.dequant_mean_rows(q, e, mode, 32),
                                                        mode, 32),
                         lambda: quantize.quantize_rows_plain(
                             quantize.dequant_mean_rows_plain(q, e, mode, 32), mode, 32),
                         2 * (qbytes + xbytes), 6 * x.numel() + nfloats),
            }
            out = torch.empty_like(x)
            fill_ms, _ = device_ms(torch, lambda: out.fill_(1.0), 50)  # K2b's writes alone
            if not one_row:
                del cases["dequant_mean_rows out_rows=1"]
            else:  # the timed one-row form, bitwise its plain version on these inputs
                kern, plain = cases["dequant_mean_rows out_rows=1"][:2]
                if not np.array_equal(u8(torch, kern()), u8(torch, plain())):
                    raise AssertionError(f"K2b out_rows=1 {mode} P={parties}: differs from "
                                         "the plain version")
            for name, (kern, plain, nbytes, flops) in cases.items():
                t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                t_ops = flops / F32_FLOPS_PER_S * 1e3
                ms, queued = device_ms(torch, kern, 50)
                plain_ms, plain_queued = device_ms(torch, plain, 5)
                if not (queued and plain_queued):
                    raise AssertionError(f"{name}: the host did not queue the timed calls "
                                         "behind the spin kernel")
                r = {"ms": ms, "plain_ms": plain_ms,
                     "host_ms": time_ms(torch, kern, 50),
                     "plain_host_ms": time_ms(torch, plain, 5),
                     "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                     "bytes": nbytes, "flops": flops, "shape": [parties, width], "mode": mode,
                     "form": forms.get(name.split()[0], "both"), "l2_resident": xbytes + qbytes <= 50e6,
                     "fill_ms": fill_ms if name in ("dequant_mean_rows",
                                                    "dequant_mean_rows mean=False") else None,
                     "wire_ratio": (q[0].numel() * q.element_size() + e[0].numel()) / width}
                res[(name, parties, mode)] = r
                if name == "quantize_rows":
                    log(f"phase11 {mode} wire bytes per party per step from the gathered "
                        f"dtypes ({q.dtype}, {e.dtype}): {r['wire_ratio']:.4f} of the f32 row")
                log(f"phase11 {name} {mode} P={parties} W={width} ({r['form']} form"
                    f"{', in L2' if r['l2_resident'] else ''}): device {r['ms']:.6f} ms, bound "
                    f"{r['bound_ms']:.6f} ms by {r['bound_by']} ({100 * r['bound_ms'] / r['ms']:.1f} %"
                    f" of it), plain {r['plain_ms']:.6f} ms; back to back through the wrapper "
                    f"{r['host_ms']:.6f} ms (plain {r['plain_host_ms']:.6f})"
                    + (f"; fill_ of its output alone {fill_ms:.6f} ms" if r["fill_ms"] else "")
                    + "; no single PyTorch call computes it")
    return res


def session_timings(torch, mcd, mcc):
    """Phase 11: ms per step of full-width sessions (the session's own
    clock, first dispatch to the fetched row), best and mean of 3."""
    parties, width, steps = SESSIONS["full"]
    ops = [r.tobytes() for r in session_rows("full", parties, width)]
    dm = mcc._pmean_dm(width)
    res = {}
    for mode in ("none", "int8", "int4"):
        els = []
        for i in range(4):
            _, _, el = mcd.run_dispatch_session(list(range(parties)), 0, dm, ops, steps,
                                                quantize=mode)
            if i:
                els.append(el)
        wire = dm.quantized(mode).wire_bytes() / width
        res[mode] = {"ms_per_step_best": min(els) / steps * 1e3,
                     "ms_per_step_mean": sum(els) / len(els) / steps * 1e3, "wire_ratio": wire}
        res[mode].update(session_profile(torch, mcd, dm, ops, steps, mode))
        log(f"phase11 session {mode} {parties} parties x {width} B x {steps} steps: "
            f"{res[mode]['ms_per_step_best']:.6f} ms/step best of 3, "
            f"{res[mode]['ms_per_step_mean']:.6f} mean; wire bytes per party per step "
            f"{wire:.4f} of the f32 row; one session under torch.profiler: wall "
            f"{res[mode]['wall_us']:.1f} us, device busy {res[mode]['device_us']:.1f} us "
            f"(idle {100 - 100 * res[mode]['device_us'] / res[mode]['wall_us']:.1f} %); "
            f"by kernel {res[mode]['top']}")
    return res


def session_profile(torch, mcd, dm, ops, steps, mode):
    """One session under torch.profiler: wall time, device busy time and
    the kernels that take it."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        mcd.run_dispatch_session(list(range(len(ops))), 0, dm, ops, steps, quantize=mode)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kern = [e for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")]
    dev_us = lambda e: getattr(e, "self_device_time_total", None) or getattr(  # noqa: E731
        e, "self_cuda_time_total", 0)
    top = sorted(kern, key=dev_us, reverse=True)[:4]
    return {"wall_us": wall_us, "device_us": sum(dev_us(e) for e in kern),
            "top": [(e.key[:48], round(dev_us(e), 1), e.count) for e in top]}


def run_k2_phases(torch, kernels, dev):
    from incubator_brpc_tpu_torch.ops import quantize
    from incubator_brpc_tpu_torch.parallel import mc_collective, mc_dispatch
    from incubator_brpc_tpu_torch.parallel import quantized as Q
    from incubator_brpc_tpu_torch.rpc.device_method import DeviceMethod
    from incubator_brpc_tpu_torch.transport import mc_worker

    # -- phase 9: K2 against its plain versions and the numpy twin ------------
    forms = {}
    for mode in ("int8", "int4"):
        for case in K2_CASES:
            parties, width, block, layout = case
            got = k2_case(torch, quantize, Q, dev, parties, width, block, mode, layout)
            want = k2_expected_forms(block, mode, layout)
            if got != want:
                raise AssertionError(f"K2 {mode} {case}: forms {got}, want {want}")
            forms[f"{mode} {case}"] = got
    torch.cuda.synchronize()

    # -- phase 10: the session path, counted ----------------------------------
    kernels.reset_launch_counts()
    checked, session_bases = run_sessions(torch, kernels, mc_dispatch, mc_collective, Q,
                                          DeviceMethod, mc_worker)
    launches = kernels.launch_counts()
    log(f"phase10 launches on the session path: {launches}")
    missing = [name for name in K2 if launches[name] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the session path: {missing}")

    # -- phase 11: timings ------------------------------------------------------
    timings = k2_timings(torch, quantize, dev)
    sessions = session_timings(torch, mc_dispatch, mc_collective)
    line = {name: {k: timings[(name, 8, "int8")][k]
                   for k in ("ms", "plain_ms", "bound_ms", "bound_by", "shape", "mode", "form")}
            for name in K2}
    for name in K2:
        line[name]["library_ms"] = None
        line[name]["host_ms"] = timings[(name, 8, "int8")]["host_ms"]
        line[name]["int4_ms"] = timings[(name, 8, "int4")]["ms"]
        line[name]["p64_ms"] = timings[(name, 64, "int8")]["ms"]
        line[name]["p64_bound_ms"] = timings[(name, 64, "int8")]["bound_ms"]
    # -- phase 10b: the session plane over RPC, counted ----------------------
    t0 = time.perf_counter()
    plane, plane_a, plane_b = session_plane_phase(torch, kernels, bases=session_bases["full"])
    plane["phase_s"] = time.perf_counter() - t0
    log(f"phase10b: {plane['phase_s']:.1f} s, the servers' and processes' start included")
    one_row = {k: timings[k] for k in timings if k[0] == "dequant_mean_rows out_rows=1"}
    for name in K2:
        line[name]["plane_launches"] = {"in_process": plane_a[name], "across_processes": plane_b[name]}
    for key in ("ms", "bound_ms", "plain_ms", "bound_by"):
        line["dequant_mean_rows"][f"one_row_{key}"] = one_row[
            ("dequant_mean_rows out_rows=1", 3, "int8")][key]
    detail = {"timings": {f"{n} P={p} {m}": t for (n, p, m), t in timings.items()},
              "sessions": sessions, "forms": forms, "plane": plane,
              "checked": {f"{n} {m}": c for (n, m), c in checked.items()}}
    return {"launches": launches, "line": line, "detail": detail}


def k2_only(root: str, out) -> int:
    """``--k2-only ROOT``: phase 11 alone (K2's timings and the full-width
    sessions') for the port under ROOT, a tree of this repository unpacked
    from any commit (``git archive``), so that two trees are timed in turns
    on one card: parent, change, change, parent."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: PyTorch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(root))
    from incubator_brpc_tpu_torch.ops import kernels, quantize
    from incubator_brpc_tpu_torch.parallel import mc_collective, mc_dispatch

    card = card_line()
    log(card)
    log(f"k2-only: the port at {quantize.__file__}")
    kernels.build()
    dev = torch.device("cuda", 0)
    timings = k2_timings(torch, quantize, dev)
    sessions = session_timings(torch, mc_dispatch, mc_collective)
    result = {"card": card, "root": root,
              "timings": {f"{n} P={p} {m}": t for (n, p, m), t in timings.items()},
              "sessions": sessions}
    if out:
        with open(out, "w") as f:
            json.dump(result, f, indent=1)
    log(card)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the detailed timings to this JSON file")
    ap.add_argument("--k2-only", metavar="ROOT",
                    help="run phase 11 alone on the port of the tree at ROOT (k2_only)")
    opts = ap.parse_args()
    if opts.k2_only:
        return k2_only(opts.k2_only, opts.out)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: PyTorch sees no CUDA device", file=sys.stderr)
        return 2

    from incubator_brpc_tpu_torch.models.tensor_echo import TensorEchoService, make_echo_step
    from incubator_brpc_tpu_torch.ops import kernels
    from incubator_brpc_tpu_torch.rpc import shutdown_host_plane
    from incubator_brpc_tpu_torch.transport.device import MAX_BUCKET_WORDS, DeviceEndpoint

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = card_line()
    log(card)
    log(f"phase1 card: {torch.cuda.get_device_name(0)} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    kernels.build()
    log(f"phase1 build: {time.perf_counter() - t0:.3f}s")
    ptxas = ptxas_report(kernels.build_log(),
                         K3 + (DELTA_VEC,) + K4 + K4E + ("mse_loss_sum", K4F_KERNEL) + K2_KERNELS)
    for name, entries in ptxas.items():
        for e in entries:
            log(f"  ptxas {name}: {e.get('registers')} registers, spill stores "
                f"{e.get('spill_stores')} B, spill loads {e.get('spill_loads')} B ({e['entry'][:60]})")

    # -- phase 2: kernels against their plain versions ------------------------
    p2 = Phase2(torch, kernels, dev)
    for rows, words in GEOMETRIES:
        p2.run(rows, words)
    log(f"phase2 max_abs_err {p2.max_err}")

    # -- phase 3: the main path, counted --------------------------------------
    svc = TensorEchoService()
    svc.add_method(3, lambda p: kernels.bits32(kernels.u64(p) * 2))
    svc.add_method(5, lambda p: kernels.bits32(kernels.u64(p) + 10))
    kernels.reset_launch_counts()

    echo_ep = DeviceEndpoint(window_size=16, max_batch=16)
    echo_ep.warm(256)
    qps, lat = run_calls(echo_ep, 16, 8, 256, lambda i, j: 0, 1)
    log(f"phase3 echo endpoint, 16 threads x 8 calls of 256 B: qps {qps:.1f}, mean latency {lat:.1f} us")

    mixed_ep = DeviceEndpoint(service=svc, window_size=16, max_batch=16)
    mixed_ep.warm(256)
    qps, lat = run_calls(mixed_ep, 16, 8, 256,
                         lambda i, j: 999 if (i, j) == (5, 3) else (0, 3, 5)[(i + j) % 3], 2)
    log(f"phase3 mixed endpoint {{0,3,5,999}}, 16 threads x 8 calls of 256 B: qps {qps:.1f}, "
        f"mean latency {lat:.1f} us")
    mixed_ep.warm(32 * 1024)
    qps, lat = run_calls(mixed_ep, 16, 1, 32 * 1024, lambda i, j: (0, 3, 5)[i % 3], 3)
    log(f"phase3 burst of 16 calls of 32 KiB: qps {qps:.1f}, mean latency {lat:.1f} us")
    qps, lat = run_calls(mixed_ep, 1, 1, 4 * MAX_BUCKET_WORDS, lambda i, j: 3, 4)
    log(f"phase3 one call at the largest bucket ({MAX_BUCKET_WORDS} words, method 3): "
        f"latency {lat:.1f} us")

    rng = np.random.default_rng(19)
    direct_payloads = iter([rng.integers(0, 256, size=256, dtype=np.uint8).tobytes()
                            for _ in range(20)])

    def direct_one():
        p = next(direct_payloads)
        if echo_ep.call_bytes(p, timeout=300) != (0, p):
            raise AssertionError("sequential endpoint call failed")

    direct_seq_us = sequential_us(direct_one, 20)
    log(f"phase3 echo endpoint, 20 sequential calls of 256 B: {direct_seq_us:.1f} us a call")

    step, request = make_echo_step(payload_words=1 << 26)
    response = step(request)
    torch.cuda.synchronize()
    h = kernels.u64(response[:8]).tolist()
    if h[0] != kernels.MAGIC or h[1] != 1 << 26 or h[2] != 1 or h[7] != 0 or h[6] != kernels.u64(request[6]).item():
        raise AssertionError(f"make_echo_step 2^26: header {h}")
    if not torch.equal(response[8:].view(torch.int32), request[8:].view(torch.int32)):
        raise AssertionError("make_echo_step 2^26: payload not echoed")
    launches = kernels.launch_counts()
    log(f"phase3 launches on the endpoint path: {launches}")
    missing = [name for name in K1 if launches[name] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the endpoint path: {missing}")
    for ep in (echo_ep, mixed_ep):
        if not ep.close(timeout=120):
            raise AssertionError("an endpoint did not settle its calls")

    # -- phase 3b: device RPC through the port's Server and Channel, counted --
    kernels.reset_launch_counts()
    rpc = device_rpc_phase(torch, kernels, svc, direct_seq_us)
    rpc_launches = kernels.launch_counts()
    log(f"phase3b launches on the RPC path: {rpc_launches}")
    missing = [name for name in K1 if rpc_launches[name] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the RPC path: {missing}")
    shutdown_host_plane()

    # -- phase 3c: the two-party device link, counted -------------------------
    link, link_k1, link_k2 = device_link_phase(torch, kernels, svc)

    # -- phase 3d: the combo channels and load balancers, counted -------------
    t0 = time.perf_counter()
    combo, combo_launches = combo_phase(torch, kernels, svc)
    combo["phase_s"] = time.perf_counter() - t0
    log(f"phase3d: {combo['phase_s']:.1f} s, the servers' start and stop included")

    # -- phase 3e: streams and the multi-controller link across processes ----
    t0 = time.perf_counter()
    mc, mc_k1 = mc_phase(torch, kernels)
    mc["phase_s"] = time.perf_counter() - t0
    log(f"phase3e: {mc['phase_s']:.1f} s, the worker processes' start included")

    # -- phase 3f: the native host runtime, device RPC behind it counted ------
    log(f"phase3f on {card_line()} (every figure below is this card's and its host's)")
    t0 = time.perf_counter()
    native, native_k1 = native_phase(torch, kernels, rpc)
    native["phase_s"] = time.perf_counter() - t0
    missing = [name for name in ("frame_rows", "echo_step_rows") if native_k1[name] == 0]
    if missing:
        raise AssertionError(f"phase3f (c): kernels not launched behind the native plane: {missing}")
    shutdown_host_plane()
    log(f"phase3f: {native['phase_s']:.1f} s, the host runtime's second build included")

    # -- phase 3g: the server and channel policies, device RPC counted --------
    log(f"phase3g on {card_line()} (every figure below is this card's and its host's)")
    t0 = time.perf_counter()
    policies, policy_k1 = policy_phase(torch, kernels)
    policies["phase_s"] = time.perf_counter() - t0
    for part in ("a", "d", "e"):
        missing = [name for name in ("frame_rows", "echo_step_rows") if policy_k1[part][name] == 0]
        if missing:
            raise AssertionError(f"phase3g ({part}): kernels not launched: {missing}")
    shutdown_host_plane()
    log(f"phase3g: {policies['phase_s']:.1f} s; K1 launches by part {policy_k1}")

    # -- phase 3h: baidu_std, HTTP and json2pb, device RPC counted ------------
    log(f"phase3h on {card_line()} (every figure below is this card's and its host's)")
    t0 = time.perf_counter()
    protocols, protocol_k1 = protocol_phase(torch, kernels)
    protocols["phase_s"] = time.perf_counter() - t0
    for part in ("a", "b", "d"):
        missing = [name for name in ("frame_rows", "echo_step_rows") if protocol_k1[part][name] == 0]
        if missing:
            raise AssertionError(f"phase3h ({part}): kernels not launched: {missing}")
    shutdown_host_plane()
    log(f"phase3h: {protocols['phase_s']:.1f} s; K1 launches by part {protocol_k1}")

    # -- phase 3i: rpcz spans, the portal and the profilers, device RPC counted
    log(f"phase3i on {card_line()} (every figure below is this card's and its host's)")
    t0 = time.perf_counter()
    rpcz_fig, rpcz_k1 = rpcz_phase(torch, kernels)
    rpcz_fig["phase_s"] = time.perf_counter() - t0
    for part in ("a", "b", "c", "e"):
        missing = [name for name in ("frame_rows", "echo_step_rows") if rpcz_k1[part][name] == 0]
        if missing:
            raise AssertionError(f"phase3i ({part}): kernels not launched: {missing}")
    shutdown_host_plane()
    log(f"phase3i: {rpcz_fig['phase_s']:.1f} s; K1 launches by part {rpcz_k1}")

    # -- phase 4: the standalone step -----------------------------------------
    for words in (256, 1 << 26):
        step, request = make_echo_step(payload_words=words)
        iters = 1000 if words == 256 else 20
        ms = time_ms(torch, lambda: step(request), iters)
        req_i32 = request.view(torch.int32)
        dst = torch.empty_like(req_i32)
        copy_ms = time_ms(torch, lambda: dst.copy_(req_i32), iters)
        nbytes = 2 * 4 * (words + 8)
        log(f"phase4 make_echo_step W={words}: {ms * 1e3:.3f} us/step, "
            f"{nbytes / ms / 1e6:.3f} GB/s; copy_ of the same bytes {copy_ms * 1e3:.3f} us, "
            f"{nbytes / copy_ms / 1e6:.3f} GB/s")
    # the echo path's 2^26-word frames (0.75 GiB) would count in phase 7's peak memory
    del step, request, response, req_i32, dst

    # -- phases 5-8: K3 and the FabricNet train step --------------------------
    k3 = run_k3_phases(torch, kernels, dev)

    # -- phases 9-11: K2 and the quantized collective sessions ----------------
    k2 = run_k2_phases(torch, kernels, dev)

    # -- phase 12: the kernels line, then the result line ----------------------
    line = []

    def regs(name):  # K3's entries: the most registers of any instance, all spill bytes
        entries = ptxas.get(name, [])
        return {"registers": max((e.get("registers", 0) for e in entries), default=None),
                "spill_bytes": sum(e.get("spill_stores", 0) + e.get("spill_loads", 0)
                                   for e in entries)}

    for name in K1:
        rows, words = REPORT_AT[name]
        t = p2.timings[(name, rows, words)]
        line.append({
            "name": name, "route": "cuda",
            "source": "incubator_brpc_tpu_torch/csrc/framing.cu",
            "replaces": REPLACES[name], "launches": rpc_launches[name],
            "endpoint_launches": launches[name], "link_launches": link_k1[name],
            "combo_launches": {part: combo_launches[part][name] for part in ("a", "c", "e")},
            "mc_launches": mc_k1[name], "native_launches": native_k1[name],
            "policy_launches": {part: row[name] for part, row in sorted(policy_k1.items())},
            "protocol_launches": {part: row[name] for part, row in sorted(protocol_k1.items())},
            "rpcz_launches": {part: row[name] for part, row in sorted(rpcz_k1.items())},
            "max_abs_err": p2.max_err[name], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": None,
            "host_ms": t["host_ms"], "copy_ms": t["copy_ms"], "shape": [rows, words],
        })
    for name in K3:
        line.append({
            "name": name, "route": "cuda",
            "source": K3_SOURCE.get(name, "incubator_brpc_tpu_torch/csrc/attention.cu"),
            "replaces": REPLACES[name], "launches": k3["launches"][name],
            "max_abs_err": k3["max_err"][name], **k3["line"][name], **regs(name),
        })
        if name == "attn_bwd_delta":  # registers above: the general form's
            line[-1]["vector_registers"] = regs(DELTA_VEC)
    for name in K4:  # launches: the bf16 main path's
        line.append({
            "name": name, "route": "cuda", "source": "incubator_brpc_tpu_torch/csrc/elementwise.cu",
            "replaces": REPLACES[name], "launches": k3["launches"][name],
            "max_abs_err": k3["max_err"][name], **k3["line"][name], **regs(name),
        })
    for name in K4E:  # launches: the bf16 main path's
        line.append({
            "name": name, "route": "cuda", "source": K4E_SOURCE[name],
            "replaces": REPLACES[name], "launches": k3["launches"][name],
            "max_abs_err": k3["max_err"][name], **k3["line"][name], **regs(name),
        })
    for name in K4F:  # launches: the heads = 0 path's (phase 7c)
        line.append({
            "name": name, "route": "cuda", "source": "incubator_brpc_tpu_torch/csrc/elementwise.cu",
            "replaces": REPLACES[name], "launches": k3["launches"][name],
            "max_abs_err": k3["max_err"][name], **k3["line"][name], **regs(K4F_KERNEL),
        })
    for name in K2:  # registers and spills: the vector form's instances
        vec_kernel, gen_kernel = K2_FORM_KERNELS[name]
        line.append({
            "name": name, "route": "cuda",
            "source": "incubator_brpc_tpu_torch/csrc/quantize.cu",
            "replaces": REPLACES[name], "launches": k2["launches"][name],
            "link_launches": link_k2[name], "combo_launches": combo_launches["b"][name],
            "max_abs_err": 0.0, **k2["line"][name],  # phase 9 holds K2 bitwise
            **regs(vec_kernel), "general_registers": regs(gen_kernel)["registers"],
        })
    if opts.out:
        detail = [dict(kernel=n, rows=r, words=w, **t) for (n, r, w), t in p2.timings.items()]
        with open(opts.out, "w") as f:
            json.dump({"card": card, "timings": detail, "launches": launches,
                       "rpc_launches": rpc_launches, "device_rpc": rpc,
                       "device_link": link,
                       "link_launches": {"rpc": link_k1, "device_method": link_k2},
                       "combo": combo, "combo_launches": combo_launches,
                       "multi_controller": mc, "mc_launches": mc_k1,
                       "native_plane": native, "native_launches": native_k1,
                       "policies": policies, "policy_launches": policy_k1,
                       "protocols": protocols, "protocol_launches": protocol_k1,
                       "rpcz": rpcz_fig, "rpcz_launches": rpcz_k1,
                       "k3": k3["detail"], "fabricnet": k3["fabricnet"],
                       "fabricnet_f32": k3["fabricnet_f32"],
                       "fabricnet_sliced": k3["fabricnet_sliced"],
                       "fabricnet_heads0": k3["fabricnet_heads0"],
                       "fabricnet_mesh": k3["fabricnet_mesh"], "k2": k2["detail"],
                       "k2_launches": k2["launches"], "ptxas": ptxas}, f, indent=1)
    gone = [n for n in REMOVED if n in kernels.KERNELS]
    if gone:
        raise AssertionError(f"kernels replaced by the port still registered: {gone}")
    log(f"phase12 {', '.join(REMOVED)}: replaced, no wrapper launches it (launches 0)")
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s from the card probe to the kernels line")
    log(card)
    log(json.dumps({"kernels": line}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
