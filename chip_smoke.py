"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (each prints a line; any failure raises and exits non-zero):

1. the card's name and power limit, as nvidia-smi reports them;
2. build of the CUDA kernels raft_tpu_torch/csrc/gj_solve.cu,
   fused_block.cu, tile_inv.cu and mm.cu (one nvcc each, started
   together, sm_90a), with the compiler's register report and the build
   seconds;
3. the Gauss-Jordan kernel against its plain PyTorch version on the card
   at the main path's shape [1536, 12, 13], in float64 and float32, with
   zero-diagonal systems (row swaps) and one NaN system, bit for bit; its
   launch shape (CTAs and threads, every SM covered); the time of a call,
   the plain version's and ``torch.linalg.solve``'s (the yardstick; the
   port never calls it) by CUDA events, the kernel's device time beside
   them (a CUDA graph of launches, without the host's cost of a call);
   its bound;
4. the fused fixed-point block kernel against its plain version on the
   flagship's own prelude operands at rung 16, K = 4, float64 and
   float32, from the state after one block (lanes converge inside this
   one) with one NaN lane; its cluster size and CTA count; call time and
   device time as in 3, the plain version's and the port's torch
   waterfall block's (the nearest comparison: no single PyTorch call
   computes this function), and the kernel's bound;
5. the legacy main path in float64: the flagship design (128
   frequencies x 12 JONSWAP cases) through ``Model(design)`` on the card
   — ``analyze_unloaded``, ``solve_eigen`` and ``analyze_cases`` twice;
   the second, warm call is timed (host prep / dynamics) and its kernel
   launches counted, and its response is held against the same port run
   on the CPU; the warm host prep is printed beside its time with the
   catenary under torch.func, and the warm call beside raft_tpu's warm
   ``analyze_cases`` on a CPU;
6. the legacy main path in float32 on the card, RAO L-inf against the
   float64 card run;
7. ``analyze_cases(fixed_point="waterfall")``, float64: Xi and every
   SolveReport field bit-identical to the legacy card run;
8. ``analyze_cases(fixed_point="fused")``, float64: flags identical to
   legacy, Xi within rtol 1e-8 / atol 1e-12, one fused launch per
   block and only the finalize ladder's 6 Gauss-Jordan launches;
9. a heterogeneous 64-lane megabatch with per-lane node bundles through
   ``waterfall_dispatch``: the rungs descend, the waterfall is
   bit-identical to the legacy batch of the same lanes, the fused mode
   agrees to round-off, a dispatch suspended after its first block and
   resumed is bit-identical to an uninterrupted one, and the dispatch's
   ``flops_executed`` is the analytic count;
10. mixed precision with float32 working dtype in the waterfall mode:
    RAO against the same policy on the CPU (within 1e-4) and against
    the float64 card run (printed; the policy's own error);
10a. the aero main path: ``demo_semi_aero`` (the semi with the rotor,
    aeroServoMod 2, 128 frequencies x 12 cases, six of them with wind at
    8..18 m/s) through ``Model(design)`` on the card — ``analyze_unloaded``
    and ``analyze_cases`` cold, then warm in the legacy, waterfall and
    fused modes, each timed (host prep / dynamics) with its kernel
    launches counted: the waterfall bit-identical to legacy, the fused
    mode with identical flags and Xi within rtol 1e-8 / atol 1e-12, and
    Xi and every rotor channel within 1e-8 of the same port run on the
    CPU;
11. the BEM solve's pivot-tile inverse kernel (one thread-block cluster
    per tile; its cluster size and shared memory per CTA printed) against
    its plain version at [512, 512] in float32 and float64 with a row swap
    at every step, bit for bit; kernel, plain and ``torch.linalg.inv``
    (the yardstick) times and the bound;
12. the matrix-product kernels ``mm`` and ``mm_sub`` against their plain
    versions at the two products of one folded elimination step at
    2N = 5120 (Dinv @ [D | Db] and [A | b] - C @ [Arow | brow], 7
    right-hand sides padded to 8), float32 and float64; kernel, plain,
    cuBLAS (the yardstick: for ``mm`` the plain ``L @ R`` itself, for
    ``mm_sub`` ``torch.addmm``) times and the bound;
13. the native BEM solve: the flagship with every member potential-flow
    at its default panel sizes (2470 panels padded to 2560, so the real
    block system has 5120 rows, 10 pivot blocks of 512) through
    ``Model(design).run_bem()`` on the card, with 10 / 10 / 10 launches
    of tile_inv / mm / mm_sub per solved frequency, timed as host (mesh,
    Rankine) and device (assembly, solve) time; one frequency held
    against the same card form on the CPU; the wave term's Chebyshev
    evaluation at one assembly row block of that mesh in the port's
    gathered form and raft_tpu's masked form, held together and timed;
14. the main path with those coefficients: ``analyze_cases`` in float64
    on the card, every case converged, Xi within 1e-8 of the CPU run
    with the same coefficients.
15. the bridled main path: ``demo_semi_bridled`` (line 1 a crow's-foot
    bridle, 128 frequencies x 12 cases) through ``Model`` on the card in
    the legacy, waterfall and fused modes (the warm calls timed, host
    prep / dynamics): junction residual below 1e-5, the waterfall
    bit-identical to legacy, the fused mode within rtol 1e-8, Xi and
    every tension channel within 1e-8 of the CPU run;
16. ``analyze_unloaded(ballast=1 | 2)`` of the semi and the bridled semi
    on the card against the CPU: the trimmed fills and the residual
    heave bit for bit (host work);
17. the headline sweep: ``run_draft_ballast_sweep`` of the aero semi
    (12 cases x 128 frequencies, six with wind) over 16 drafts (0.9-1.1)
    x 16 ballast density scales (1.2-1.8), draft groups of 4 (each one waterfall descent of 768 lanes
    at the 1024 rung), in the waterfall and fused modes and once more in
    the waterfall mode with the case-axis overlap: total time, time per
    design, the stage split, the launches, the rungs and padding share,
    the guided-rotor lane accounting, non-converged and retried lanes,
    peak device memory; rows (0, 0), (7, 9), (15, 15) against the direct
    ``Model`` on the card within raft_tpu's bars; fused against waterfall
    within 1e-8; ``gj_solve`` and ``fused_block`` against their plain
    versions on the sweep's own 1024-lane operands; the draft prep on
    one thread and on eight;
18. ``run_design_sweep`` of 16 bridled semis (main leg 750-780 m) with
    the density trim against the direct ``Model`` (every design's
    delta_rho to 1e-6; designs 0, 8 and 15's Xi0 and T_moor to 1e-8 and
    |Xi| within raft_tpu's bars), and
    ``run_sweep`` of the semi's 6-point grid run again from its
    checkpoints, bit-identical;
19. the Gauss-Jordan solve's backward (``dynamics.GaussSolve``) at
    [1536, 12, 13] in float64 and float32: one backward launch of the
    kernel on the transposed systems [A^T | g], A_bar and b_bar against
    the plain version's backward within 1e-12 max|x| (float64),
    ``gradcheck`` on the card, the backward's call and device times,
    its bound and ``torch.linalg.solve``'s backward (the yardstick);
20. exact design gradients on the card, on the flagship and the aero
    design: ``parametric.design_gradients`` (values within 1e-10 and the
    Jacobian within 1e-8 of the port on the CPU, every entry within 1e-4
    of central differences of the port's own response on the card), then
    ``grad.design_value_and_grad`` for rao_pitch_peak and pitch_max_deg
    (the value bit-identical to the response's, the gradient within 5e-3
    of the differences), with the forward/backward seconds, the
    host/device split, the adjoint trips and the gj_solve launches
    forward and backward; a lane with an injected NaN gives an all-zero
    gradient and the nonfinite flag;
21. batched design prep: 256 flagship designs (16 drafts x 16 column
    diameters) through ``batched_prep.PrepFamily.prepare`` on the card
    against solo prep (raft_tpu's round-off bars), bits across block
    compositions, the geometry program on the card and on the CPU, and
    ``run_design_sweep(batched_prep=True)`` against ``False`` (1e-10),
    the prep stage's seconds both ways and the designs each path took;
22. ``RAFT_OMDAO`` (the openmdao-less shim) on the flagship as a
    component (member stations normalized, one coefficient set per
    member, the flat inputs from this script's own helper): compute()
    twice, the warm call timed with its gj_solve launches; its stats,
    aggregates and properties within 1e-10 of their scale of the direct
    ``Model`` on the card and of the same component on the CPU;
    compute_partials twice (the cold call builds the adjoint programs),
    the warm one timed with its forward and backward launches, within
    1e-8 of the CPU component's and within raft_tpu's bars of central
    differences of compute() on the card (ballast and line length 5e-3,
    column diameter 5e-2, eps 2e-3); the same compute + compute_partials
    loop on the card host's CPU beside it; then one compute() with
    ``run_native_BEM`` on the potential-flow flagship, with its
    tile_inv / mm / mm_sub launches, its coefficients within phase 13's
    bars of phase 13's and its stats within 1e-10 of the direct Model
    with those coefficients;
23. ``python -m raft_tpu_torch <flagship.yaml> --plot`` in a
    subprocess in a temporary directory (exit 0, the natural
    frequencies and the case analysis printed, both figures non-empty;
    where matplotlib is not installed, the analysis printed and the
    command failing on it), then ``__main__.main`` in this process with
    its gj_solve launches counted (the same natural frequencies), and
    ``main(["serve", "--http", "0"])`` raising, naming ROADMAP step 12b;
24. ``validate.checked_pipeline`` on the flagship on the card: Xi and
    the report bit-identical to the unchecked pipeline and to
    ``analyze_cases``, its launches counted, its time beside the
    unchecked one; a poisoned C_lin and a poisoned F_add_r each raise a
    ``FloatingPointError`` naming its phase;
25. serve coalesce: ten requests (eight flagship ballast variants, two
    aero semis, 128 frequencies x 12 cases each, one 96-node x 32-slot
    bucket) from four client threads through ``serve.Engine`` on the card
    (window 5 ms): fewer dispatches than requests; each result
    ``torch.equal`` to the same request served alone in a fresh engine
    and to ``Model(design, slots=bucket)``, and within 1e-12 of the
    un-bucketed ``Model``; gj_solve on the operands of one served
    dispatch (the bucket's n_slots x nw systems) bit-equal to its plain
    version; gj_solve launches per dispatch, occupancy, p50 and p95
    latency;
26. serve fused: the same requests with ``fixed_point="fused"``: the
    fused_block launches, alone == coalesced == ``Model(slots=)``, within
    phase 8's bar of phase 25's bits, flags identical; fused_block on the
    operands of one served block (the padded bucket's nodes, padding
    lanes copied from lane 0) against its plain version: i / done / froze
    equal, amplitudes within 1e-12 of max|x|;
27. serve sweep: 64 draft-scaled aero semis as one sweep (chunks of 8
    designs) uninterrupted, then under interactive load with preemption
    on (suspended chunks parked on the card) and off:
    every run ``torch.equal`` to the uninterrupted one, the yields, the
    interactive p50 and p95 each way;
28. serve faults: chaos ``nan_lane`` (own lanes quarantined, the mate
    bit-identical), a transient ``backend_error`` retried to the same
    bits, ``dispatch_stall`` to ``watchdog_timeout`` and the breaker to
    ``rejected_circuit`` and back, a result-cache hit with the same bits
    and no dispatch; every result served on the card;
29. serve warm restart: ``python -m raft_tpu_torch serve`` subprocesses
    answering two stdin design lines, cold on an empty cache directory,
    then warm on the same one (the manifest replayed, no nvcc, the same
    bits) and with two unseen designs (the manifest alone): the buckets
    replayed, the first-request latencies;
30. serve grad: ``Engine.submit_grad`` on the flagship within 1e-8 of
    ``grad.design_value_and_grad`` on the card, with its launches.

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.  In the kernel table ``ms`` is the
time of one call from Python (as ``plain_ms`` and ``library_ms`` are
taken); ``device_ms``, where given, the kernel's device time alone; the
``backward_*`` keys of ``gj_solve`` are phase 19's, its
``launches_backward_grad`` the backward launches of phase 20's flagship
Jacobian, ``launches_batched_prep_sweep`` phase 21's batched sweep,
``launches_omdao`` / ``launches_backward_omdao`` phase 22's warm
compute() and compute_partials, ``launches_cli`` and
``launches_checked`` phases 23 and 24; ``launches_omdao_bem`` of the BEM
kernels is phase 22's run_native_BEM compute().
Without CUDA, or without the raft_tpu_torch package beside it, the script
exits non-zero and prints no result.
"""

import contextlib
import copy
import io
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth, the FP64
# rate with the FP64 tensor cores (DMMA; 34 TFLOP/s without them) and the
# FP32 rate outside the tensor cores.  A float32 matrix product (or a
# tile inverse, which a blocked form makes of products) has a faster
# full-f32-accurate path: three TF32 tensor-core passes (hi*hi + hi*lo +
# lo*hi) at 495 TFLOP/s, so 165 TFLOP/s; its bound takes that rate, since
# a bound must not be beatable by another implementation of the same work
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.float64: 67e12, torch.float32: 67e12}
PEAK_PRODUCT_FLOPS = {torch.float64: 67e12, torch.float32: 495e12 / 3}
# GJ solves of one recovery-ladder pass (raft_tpu_torch/dynamics.py):
# tier 0 solve + 1 refinement, tier 1's 2 refinements, the condition
# estimate, the Tikhonov solve
LADDER_SOLVES = 6
B, N, M = 1536, 12, 13
# the fused-kernel phase: rung, trips per block, the NaN lane (a padding
# lane of the 12 cases)
RUNG, K_BLOCK, NAN_LANE = 16, 4, 13
MEGA_LANES = 64
# the BEM solve's pivot tile
N_TILE = 512
# RAO L-inf (relative to the peak) of the mixed-precision policy against
# float64 on the flagship, measured on the CPU for raft_tpu and the port
# alike by tests/torch_mp_policy_linf.py: 4.24e-2 (docs/torch_port.md
# section 6)
MP_POLICY_LINF = 5e-2
# printed beside the flagship's warm legacy call: its host prep on an H100
# while the catenary Newton ran under torch.func transforms, and the mark
# for the whole call, raft_tpu's warm analyze_cases of the flagship on a
# CPU (docs/torch_port.md section 5 has both; tests/torch_host_prep_
# timing.py measures raft_tpu's on the host it runs on)
HOST_PREP_FUNCTORCH_S = "0.69-1.32"
RAFT_TPU_CPU_ANALYZE_S = 0.175
# the rotor's output channels (raft_tpu_torch/model.py _save_case_outputs)
ROTOR_CHANNELS = ("omega_avg", "omega_std", "omega_max", "omega_PSD",
                  "torque_avg", "torque_std", "torque_PSD", "power_avg",
                  "bPitch_avg", "bPitch_std", "bPitch_PSD", "wind_PSD",
                  "Mbase_avg", "Mbase_std", "Mbase_PSD")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def flagship(rt):
    return rt.designs.flagship(0.00625, 0.8, 12)


def aero_design(rt):
    return rt.designs.demo_semi_aero(n_cases=12, n_wind=6,
                                     nw_settings=(0.00625, 0.8))


def cuda_ms(fn, iters, warmup=3):
    """Mean milliseconds of ``fn`` over ``iters`` back-to-back calls,
    by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters, reps=5):
    """Device milliseconds of one ``fn`` call: ``iters`` calls captured
    in a CUDA graph and replayed ``reps`` times between CUDA events, so
    the host's cost of each call (allocation, argument marshalling, the
    launch itself) is left out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * iters)


def bound(nbytes, flops, dtype, product=False):
    """Least time (ms) on this card: bytes over the memory rate or
    operations over the FP rate of ``dtype`` (for a matrix ``product``,
    the tensor cores' full-accuracy rate), whichever is larger."""
    t_bytes = nbytes / PEAK_BYTES_S
    t_ops = flops / (PEAK_PRODUCT_FLOPS if product else PEAK_FLOPS)[dtype]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops \
        else "operations"


def dtype_name(dtype):
    return str(dtype).removeprefix("torch.")


# ---------------------------------------------------------------- build

def build_phase(kernel_modules):
    """Start every nvcc at once, then wait for each module's builds."""
    t0 = time.perf_counter()
    jobs = [(km, km.start_build(verbose=True)) for km in kernel_modules]
    n = 0
    for km, job in jobs:
        km.build(verbose=True, job=job)
        for src in km.SOURCES:
            n += 1
            print(f"phase build: {src} -> sm_90a, done "
                  f"{time.perf_counter() - t0:.2f} s after the start",
                  flush=True)
    print(f"phase build: {n} sources in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)


# ----------------------------------------------------------- gj kernel

def gj_inputs(dtype, seed=0):
    """[B, N, M] augmented systems: random, diagonally weighted; 64 with a
    zero diagonal (a row swap at every step); system 5 all NaN."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, N, N)) + N * np.eye(N)
    A[100:164, np.arange(N), np.arange(N)] = 0.0
    A[100:164] += np.roll(np.eye(N), 1, axis=0) * N
    b = rng.standard_normal((B, N, 1))
    Mx = np.concatenate([A, b], axis=-1)
    Mx[5] = np.nan
    return torch.as_tensor(Mx, dtype=dtype, device="cuda")


def gj_bound(dtype):
    """One [B, N, M] elimination: the input read once, M and |pivot|
    written once; N steps of M divisions and (N-1)*M multiply-subtracts
    per system."""
    item = torch.finfo(dtype).bits // 8
    nbytes = (2 * B * N * M + B * N) * item
    flops = B * N * (M + 2 * (N - 1) * M)
    return bound(nbytes, flops, dtype)


def gj_kernel_phase(gk, dtype):
    """The kernel against its plain version, bit for bit (pivots and NaN
    systems included); ``ms`` is the time of a call from Python, the way
    ``plain_ms`` and ``library_ms`` are taken, ``device_ms`` the kernel's
    device time (a CUDA graph of launches)."""
    Mx = gj_inputs(dtype)
    out_k, piv_k = gk.gj_solve(Mx)
    out_p, piv_p = gk.gj_solve_reference(Mx)
    torch.cuda.synchronize()
    for a, b in ((out_k, out_p), (piv_k, piv_p)):
        if not torch.equal(torch.isnan(a), torch.isnan(b)):
            raise AssertionError(f"{dtype}: NaN systems differ")
        fin = ~torch.isnan(b)
        if not torch.equal(a[fin], b[fin]):
            raise AssertionError(
                f"{dtype}: kernel and plain version differ: max|d| "
                f"{(a - b)[fin].abs().max().item()} (bits expected equal)")
    nan_sys = torch.isnan(out_k).flatten(1).any(1).nonzero().flatten()
    if nan_sys.tolist() != [5]:
        raise AssertionError(f"{dtype}: NaN in systems {nan_sys.tolist()}")
    fin = ~torch.isnan(out_p)
    err = max((out_k - out_p)[fin].abs().max().item(),
              (piv_k - piv_p)[~torch.isnan(piv_p)].abs().max().item())
    ctas, threads = gk.launch_shape(B)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if ctas < sms:
        raise AssertionError(f"gj_solve launches {ctas} CTAs for {sms} SMs")
    A = Mx[..., :N].clone()
    A[5] = torch.eye(N, dtype=dtype, device="cuda")
    rhs = Mx[..., N:].clone()
    rhs[5] = 0.0
    ms = cuda_ms(lambda: gk.gj_solve(Mx), 200)
    device_ms = graph_ms(lambda: gk.gj_solve(Mx), 50)
    plain_ms = cuda_ms(lambda: gk.gj_solve_reference(Mx), 20)
    library_ms = cuda_ms(lambda: torch.linalg.solve(A, rhs), 50)
    bound_ms, bound_by = gj_bound(dtype)
    print(f"phase gj kernel {dtype_name(dtype)}: [{B},{N},{M}] ctas={ctas} "
          f"threads_per_cta={threads} sms={sms} bit_identical=True "
          f"max_abs_err={err:.3e} NaN systems {nan_sys.tolist()} ms={ms:.5f}"
          f" device_ms={device_ms:.5f} plain_ms={plain_ms:.5f} library_ms="
          f"{library_ms:.5f} bound_ms={bound_ms:.6f} ({bound_by})",
          flush=True)
    return dict(max_abs_err=err, ms=ms, device_ms=device_ms,
                plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                bound_by=bound_by, ctas=ctas, threads_per_cta=threads)


# -------------------------------------------------------- fused kernel

def fused_operands(model, args, dtype):
    """The flagship's prelude at rung RUNG on the card, advanced one torch
    block; lane NAN_LANE's stiffness then NaN."""
    from raft_tpu_torch.convert import case_args_from_numpy
    from raft_tpu_torch.serve.buckets import SlotPhysics
    from raft_tpu_torch.utils.placement import complex_dtype
    from raft_tpu_torch.waterfall import _pad_rows, _phase_pipelines

    physics = SlotPhysics.from_model(model)._replace(
        dtype_name=dtype_name(dtype),
        cdtype_name=dtype_name(complex_dtype(dtype)))
    nodes = model.nodes.to("cuda", dtype)
    dev = tuple(_pad_rows(a, RUNG)
                for a in case_args_from_numpy(args, "cuda", dtype))
    prelude_fn, torch_block, _ = _phase_pipelines(
        physics, 0.8, K_BLOCK, False, False, "cuda")
    u, Fr, Fi, state = prelude_fn(nodes, *dev)
    C, Mm, Bm = dev[2:5]
    state = torch_block(nodes, u, C, Mm, Bm, Fr, Fi, state)
    C = C.clone()
    C[NAN_LANE] = float("nan")
    w = torch.as_tensor(physics.w.astype(np.float64), dtype=dtype,
                        device="cuda")
    kw = dict(w=w, dw=float(w[1] - w[0]), rho=physics.rho, relax=0.8,
              nIter=physics.nIter, K=K_BLOCK)
    return nodes, (u, C, Mm, Bm, Fr, Fi), state, kw, torch_block


def fused_kernel_phase(fk, model, args, dtype, tol):
    """The kernel against its plain version: i / done / froze identical,
    the NaN lane quarantined, amplitudes within ``tol`` * max|x|; ``ms``
    is the time of a call from Python, ``device_ms`` the kernel's device
    time (a CUDA graph of launches)."""
    nodes, ops, state, kw, torch_block = fused_operands(model, args, dtype)
    out_k = fk.fused_block(nodes, *ops, state, **kw)
    out_p = fk.fused_block_reference(nodes, *ops, state, **kw)
    torch.cuda.synchronize()
    for k, name in ((0, "i"), (4, "done"), (5, "froze")):
        if not torch.equal(out_k[k], out_p[k]):
            raise AssertionError(f"{dtype}: fused {name} differs: "
                                 f"{out_k[k].tolist()} {out_p[k].tolist()}")
    if not (out_k[5][NAN_LANE] and out_k[4][NAN_LANE]):
        raise AssertionError(f"{dtype}: NaN lane not quarantined")
    newly = (out_k[4] & ~state[4] & ~out_k[5]).nonzero().flatten().tolist()
    if not newly:
        raise AssertionError(f"{dtype}: no lane converged inside the block")
    err = max((out_k[k] - out_p[k]).abs().max().item() for k in (1, 2, 3))
    x_max = max(out_p[k].abs().max().item() for k in (1, 2, 3))
    if not err <= tol * x_max:
        raise AssertionError(
            f"{dtype}: fused kernel vs plain max|d| {err} > {tol} * {x_max}")
    L, n_nodes, _, W = ops[0].shape
    G, per_cta, smem = fk.launch_shape(n_nodes, W, dtype)
    if G < 2:
        raise AssertionError(f"fused_block runs {G} CTA per lane at W={W}")
    ms = cuda_ms(lambda: fk.fused_block(nodes, *ops, state, **kw), 50)
    device_ms = graph_ms(lambda: fk.fused_block(nodes, *ops, state, **kw),
                         10)
    plain_ms = cuda_ms(
        lambda: fk.fused_block_reference(nodes, *ops, state, **kw), 5, 1)
    block_ms = cuda_ms(lambda: torch_block(nodes, *ops, state), 5, 1)
    # the work the function needs: drag acts on the submerged nodes only,
    # so of u and the node arrays only their rows count (the kernel skips
    # the others); the submerged mask, the other operands and the state
    # are read, and the state written, once
    size = lambda t: t.numel() * t.element_size()  # noqa: E731
    n_sub = int(nodes.submerged.sum())
    per_node = (ops[0], *(getattr(nodes, f) for f in fk._NODE_FIELDS
                          if f != "submerged"))
    once = (kw["w"], nodes.submerged, *ops[1:], *state, *out_k)
    nbytes = (n_sub / n_nodes * sum(size(t) for t in per_node)
              + sum(size(t) for t in once))
    lane_trips = int((out_k[0] - state[0]).sum())
    flops = lane_trips * fk.lane_iteration_flops(n_sub, W)
    bound_ms, bound_by = bound(nbytes, flops, dtype)
    print(f"phase fused kernel {dtype_name(dtype)}: L={L} N={n_nodes} "
          f"submerged={n_sub} W={W} K={K_BLOCK} cluster={G} CTAs x {L} "
          f"lanes = {G * L} CTAs, {per_cta} frequencies and {smem} B of "
          f"shared memory per CTA lane_trips={lane_trips} "
          f"converged_in_block={newly} max_abs_err={err:.3e} (bar "
          f"{tol:g}*max|x|={tol * x_max:.3e}) ms={ms:.5f} device_ms="
          f"{device_ms:.5f} plain_ms={plain_ms:.5f} torch_block_ms="
          f"{block_ms:.5f} bound_ms={bound_ms:.6f} ({bound_by}: "
          f"{nbytes / 1e6:.2f} MB, {flops / 1e6:.1f} MFLOP)", flush=True)
    return dict(max_abs_err=err, ms=ms, device_ms=device_ms,
                plain_ms=plain_ms, torch_block_ms=block_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None, cluster=G, ctas=G * L)


# ---------------------------------------------------------- main paths

def run_main_path(rt, Timers, fixed_point="legacy", **kw):
    """Model -> analyze_unloaded -> solve_eigen -> analyze_cases (cold),
    then a warm analyze_cases with the kernels' launch counts reset just
    before it."""
    from raft_tpu_torch.kernels import fused_block as fk
    from raft_tpu_torch.kernels import gj_solve as gk

    model = rt.Model(flagship(rt), **kw)
    model.analyze_unloaded()
    fns, _ = model.solve_eigen(display=0)
    model.analyze_cases(fixed_point=fixed_point)
    gk.launches = fk.launches = 0
    with Timers() as tm:
        with tm.time("analyze_cases"):
            model.analyze_cases(fixed_point=fixed_point)
    launches = dict(gj_solve=gk.launches, fused_block=fk.launches)
    rep = tm.report()
    return model, fns, launches, {k: rep[k]["total_s"] for k in rep}


def rao(model):
    zeta = model.zeta
    mask = np.abs(zeta) > 1e-3
    return np.abs(model.Xi) / np.where(mask, np.abs(zeta), np.inf)[:, None]


def rao_linf_rel(model, ref):
    r, r_ref = rao(model), rao(ref)
    return np.abs(r - r_ref).max() / r_ref.max()


def split(times):
    return (f"analyze_cases_s={times['analyze_cases']:.4f} host_prep_s="
            f"{times['case_prep']:.4f} (mooring_s="
            f"{times['mooring_offsets']:.4f}) dynamics_s="
            f"{times['rao_solve']:.4f}")


def same_report(a, b):
    return all(np.array_equal(getattr(a, f), getattr(b, f))
               for f in a._fields)


def legacy_phases(rt, Timers):
    model, fns, launches, times = run_main_path(rt, Timers)
    rep = model.solve_report
    trips = int(rep.iters.max())
    if model.nw != 128 or model.Xi.shape != (12, 6, 128):
        raise AssertionError(f"unexpected problem size {model.Xi.shape}")
    if not rep.converged.all() or rep.nonfinite.any():
        raise AssertionError(f"unhealthy cases: {rep}")
    if not np.isfinite(model.Xi).all():
        raise AssertionError("non-finite response")
    if launches["gj_solve"] != trips + LADDER_SOLVES:
        raise AssertionError(
            f"gj_solve launches {launches} != {trips} fixed-point trips + "
            f"{LADDER_SOLVES} ladder solves")
    cpu = rt.Model(flagship(rt), device="cpu")
    cpu.analyze_unloaded()
    cpu.analyze_cases()
    xi_rel = np.abs(model.Xi - cpu.Xi).max() / np.abs(cpu.Xi).max()
    if not xi_rel <= 1e-8:
        raise AssertionError(f"card vs CPU Xi rel {xi_rel} > 1e-8")
    print(f"phase main f64: nw={model.nw} cases={model.Xi.shape[0]} "
          f"eigen_hz={np.round(fns, 5).tolist()} trips={trips} "
          f"gj_launches={launches['gj_solve']} {split(times)} "
          f"xi_rel_vs_cpu={xi_rel:.3e} iters={rep.iters.tolist()} "
          f"host_prep_with_functorch_catenary_s={HOST_PREP_FUNCTORCH_S} "
          f"raft_tpu_cpu_analyze_cases_s={RAFT_TPU_CPU_ANALYZE_S} "
          f"below_it={times['analyze_cases'] < RAFT_TPU_CPU_ANALYZE_S}",
          flush=True)

    m32, _, launches32, times32 = run_main_path(rt, Timers,
                                                precision="float32")
    rel = rao_linf_rel(m32, model)
    if not (m32.solve_report.converged.all() and rel <= 1e-4):
        raise AssertionError(f"f32 RAO L-inf rel {rel} > 1e-4 or "
                             f"unconverged {m32.solve_report}")
    print(f"phase main f32: rao_linf_rel={rel:.3e} gj_launches="
          f"{launches32['gj_solve']} {split(times32)}", flush=True)
    return model, launches


def engine_phases(rt, Timers, legacy):
    from raft_tpu_torch.waterfall import last_dispatch_stats

    wf, _, l_wf, t_wf = run_main_path(rt, Timers, fixed_point="waterfall")
    st = last_dispatch_stats()
    if not (np.array_equal(wf.Xi, legacy.Xi)
            and same_report(wf.solve_report, legacy.solve_report)):
        raise AssertionError("waterfall is not bit-identical to legacy: "
                             f"{np.abs(wf.Xi - legacy.Xi).max()}")
    if l_wf["gj_solve"] != st["blocks"] * st["block_iters"] + LADDER_SOLVES:
        raise AssertionError(f"waterfall gj launches {l_wf} vs {st}")
    print(f"phase waterfall f64: bit_identical_to_legacy=True rungs="
          f"{st['rungs']} blocks={st['blocks']} gj_launches="
          f"{l_wf['gj_solve']} lane_iters={st['lane_iters_executed']}/"
          f"{st['lane_iters_monolithic']} {split(t_wf)}", flush=True)

    fu, _, l_fu, t_fu = run_main_path(rt, Timers, fixed_point="fused")
    st = last_dispatch_stats()
    for f in ("converged", "iters", "nonfinite", "recovery_tier"):
        if not np.array_equal(getattr(fu.solve_report, f),
                              getattr(legacy.solve_report, f)):
            raise AssertionError(f"fused {f} differs from legacy")
    np.testing.assert_allclose(fu.Xi, legacy.Xi, rtol=1e-8, atol=1e-12)
    xi_rel = np.abs(fu.Xi - legacy.Xi).max() / np.abs(legacy.Xi).max()
    if l_fu["fused_block"] != st["blocks"] or not st["kernel"]:
        raise AssertionError(f"fused launches {l_fu} vs blocks {st}")
    if l_fu["gj_solve"] != LADDER_SOLVES:
        raise AssertionError(f"fused gj launches {l_fu['gj_solve']} != "
                             f"{LADDER_SOLVES}")
    print(f"phase fused f64: flags_identical=True xi_rel_vs_legacy="
          f"{xi_rel:.3e} blocks={st['blocks']} fused_launches="
          f"{l_fu['fused_block']} gj_launches={l_fu['gj_solve']} "
          f"{split(t_fu)}", flush=True)
    return l_wf, l_fu


def megabatch_phase(rt, model, args):
    """64 lanes: the 12 cases repeated, node drag coefficients swept over
    three decades, per-lane zeta and B_lin scaling, lane 7 NaN."""
    from raft_tpu_torch.convert import case_args_from_numpy
    from raft_tpu_torch.kernels.fused_block import lane_iteration_flops
    from raft_tpu_torch.model import make_case_dynamics
    from raft_tpu_torch.serve.buckets import SlotPhysics
    from raft_tpu_torch.waterfall import (
        _GJ_FLOPS, _LADDER_EXTRA_SOLVES, SuspendedWaterfall, _map_nodes,
        last_dispatch_stats, waterfall_dispatch)

    L = MEGA_LANES
    reps = -(-L // args[0].shape[0])
    a = [np.concatenate([np.asarray(x)] * reps)[:L] for x in args]
    a[0] = a[0] * np.geomspace(0.02, 50.0, L)[:, None]
    a[4] = a[4] * np.geomspace(1e-3, 1.0, L)[:, None, None, None]
    a[2][7] = np.nan
    dev = case_args_from_numpy(a, "cuda", torch.float64)
    cdf = torch.as_tensor(np.geomspace(0.2, 400.0, L), device="cuda")
    nodes = _map_nodes(lambda t: t.expand((L,) + t.shape).contiguous(),
                       model.nodes.to("cuda", torch.float64))
    for f in ("Cd_q", "Cd_p1", "Cd_p2", "Cd_End"):
        setattr(nodes, f, getattr(nodes, f) * cdf[:, None])
    physics = SlotPhysics.from_model(model)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    legacy_fn = make_case_dynamics(model.w, model.k, model.depth,
                                   model.rho_water, model.g, model.XiStart,
                                   model.nIter, torch.float64, "cuda")
    ref, t_leg = timed(lambda: legacy_fn(nodes, *dev))
    wf, t_wf = timed(lambda: waterfall_dispatch(physics, nodes, dev))
    st = last_dispatch_stats()
    if not min(st["rungs"]) < max(st["rungs"]):
        raise AssertionError(f"rungs did not descend: {st['rungs']}")
    # every lane has the flagship's submerged nodes: the analytic count is
    # the lane-iterations plus the finalize's L rows at that many nodes
    n_sub = int(model.nodes.submerged.sum())
    flops = ((st["lane_iters_executed"] + L)
             * lane_iteration_flops(n_sub, model.nw)
             + L * _LADDER_EXTRA_SOLVES * _GJ_FLOPS * model.nw)
    if st["flops_executed"] != flops:
        raise AssertionError(f"flops_executed {st['flops_executed']} != "
                             f"{flops}")
    for x, y in zip(wf[:2], ref[:2]):
        if not torch.equal(x, y):
            raise AssertionError("megabatch waterfall != legacy batch")
    if not all(torch.equal(x, y) for x, y in zip(wf[2], ref[2])):
        raise AssertionError("megabatch waterfall report != legacy batch")
    rep = ref[2]
    if not (rep.nonfinite[7] and not rep.converged[7]):
        raise AssertionError("NaN lane 7 not quarantined")
    fu, t_fu = timed(lambda: waterfall_dispatch(physics, nodes, dev,
                                                kernel=True))
    st_fu = last_dispatch_stats()
    for f in ("converged", "iters", "nonfinite", "recovery_tier"):
        if not torch.equal(getattr(fu[2], f), getattr(rep, f)):
            raise AssertionError(f"megabatch fused {f} != legacy batch")
    for x, y in zip(fu[:2], ref[:2]):
        torch.testing.assert_close(x, y, rtol=1e-8, atol=1e-12)
    polls = []

    def yield_once():
        polls.append(1)
        return len(polls) == 1

    sus = waterfall_dispatch(physics, nodes, dev, should_yield=yield_once)
    if not isinstance(sus, SuspendedWaterfall):
        raise AssertionError("the dispatch did not suspend")
    survivors = sus.survivors
    res = waterfall_dispatch(None, None, None, resume=sus)
    if not (all(torch.equal(x, y) for x, y in zip(res[:2], wf[:2]))
            and all(torch.equal(x, y) for x, y in zip(res[2], wf[2]))):
        raise AssertionError("suspended + resumed != uninterrupted")
    it = rep.iters.cpu().numpy()
    print(f"phase megabatch: lanes={L} iters {it.min()}..{it.max()} "
          f"converged={int(rep.converged.sum())} rungs={st['rungs']} "
          f"lane_iters={st['lane_iters_executed']}/"
          f"{st['lane_iters_monolithic']} flops_executed="
          f"{st['flops_executed']:.4e} waterfall_bit_identical=True "
          f"fused_flags_identical=True fused_blocks={st_fu['blocks']} "
          f"suspended_survivors={survivors} resumed_bit_identical=True "
          f"legacy_s={t_leg:.4f} waterfall_s={t_wf:.4f} fused_s="
          f"{t_fu:.4f}", flush=True)


def mixed_precision_phase(rt, Timers, legacy):
    mp, _, _, times = run_main_path(rt, Timers, fixed_point="waterfall",
                                    precision="float32",
                                    mixed_precision=True)
    cpu = rt.Model(flagship(rt), device="cpu", precision="float32",
                   mixed_precision=True)
    cpu.analyze_unloaded()
    cpu.analyze_cases(fixed_point="waterfall")
    vs_cpu = rao_linf_rel(mp, cpu)
    vs_f64 = rao_linf_rel(mp, legacy)
    if not (np.isfinite(mp.Xi).all() and vs_cpu <= 1e-4
            and vs_f64 <= MP_POLICY_LINF):
        raise AssertionError(f"mixed precision: RAO L-inf rel {vs_cpu} vs "
                             f"the CPU, {vs_f64} vs float64")
    print(f"phase mixed f32: rao_linf_rel_vs_cpu_same_policy={vs_cpu:.3e} "
          f"rao_linf_rel_vs_f64={vs_f64:.3e} iters="
          f"{mp.solve_report.iters.tolist()} {split(times)}", flush=True)


def aero_phase(rt, Timers):
    """The aero main path on the card in the three fixed-point modes (one
    Model; each warm call with the launch counts set to 0 just before it),
    held against the same port run on the CPU."""
    from raft_tpu_torch.kernels import fused_block as fk
    from raft_tpu_torch.kernels import gj_solve as gk
    from raft_tpu_torch.waterfall import last_dispatch_stats

    model = rt.Model(aero_design(rt))
    model.analyze_unloaded()
    model.analyze_cases()
    n_wind = int((model.results["means"]["aero force"][:, 0] != 0).sum())
    if model.rotor is None or model.Xi.shape != (12, 6, 128) or n_wind != 6:
        raise AssertionError(f"aero design did not run: {model.Xi.shape}, "
                             f"{n_wind} wind cases")
    out = {}
    for mode in ("legacy", "waterfall", "fused"):
        gk.launches = fk.launches = 0
        with Timers() as tm:
            with tm.time("analyze_cases"):
                model.analyze_cases(fixed_point=mode)
        out[mode] = dict(
            Xi=model.Xi.copy(), report=model.solve_report,
            launches=dict(gj_solve=gk.launches, fused_block=fk.launches),
            times={k: v["total_s"] for k, v in tm.report().items()},
            metrics={k: v.copy() for k, v in
                     model.results["case_metrics"].items()},
            stats=last_dispatch_stats() if mode != "legacy" else None)
    leg, wf, fu = out["legacy"], out["waterfall"], out["fused"]
    rep = leg["report"]
    trips = int(rep.iters.max())
    if not rep.converged.all() or rep.nonfinite.any():
        raise AssertionError(f"unhealthy aero cases: {rep}")
    if not np.isfinite(leg["Xi"]).all():
        raise AssertionError("non-finite aero response")
    if leg["launches"] != dict(gj_solve=trips + LADDER_SOLVES,
                               fused_block=0):
        raise AssertionError(f"aero legacy launches {leg['launches']}")
    if not (np.array_equal(wf["Xi"], leg["Xi"])
            and same_report(wf["report"], rep)):
        raise AssertionError("aero waterfall is not bit-identical to "
                             f"legacy: {np.abs(wf['Xi'] - leg['Xi']).max()}")
    st = wf["stats"]
    if wf["launches"]["gj_solve"] != st["blocks"] * st["block_iters"] \
            + LADDER_SOLVES:
        raise AssertionError(f"aero waterfall launches {wf['launches']}")
    for f in ("converged", "iters", "nonfinite", "recovery_tier"):
        if not np.array_equal(getattr(fu["report"], f), getattr(rep, f)):
            raise AssertionError(f"aero fused {f} differs from legacy")
    np.testing.assert_allclose(fu["Xi"], leg["Xi"], rtol=1e-8, atol=1e-12)
    if fu["launches"] != dict(gj_solve=LADDER_SOLVES,
                              fused_block=fu["stats"]["blocks"]):
        raise AssertionError(f"aero fused launches {fu['launches']}")
    cpu = rt.Model(aero_design(rt), device="cpu")
    cpu.analyze_unloaded()
    cpu.analyze_cases()
    xi_rel = np.abs(leg["Xi"] - cpu.Xi).max() / np.abs(cpu.Xi).max()
    mc = cpu.results["case_metrics"]
    ch_rel = {}
    for ch in ROTOR_CHANNELS:
        scale = np.abs(mc[ch]).max()
        if not scale > 0:
            raise AssertionError(f"rotor channel {ch} is zero")
        ch_rel[ch] = np.abs(leg["metrics"][ch] - mc[ch]).max() / scale
    worst = max(ch_rel, key=ch_rel.get)
    if not (xi_rel <= 1e-8 and ch_rel[worst] <= 1e-8):
        raise AssertionError(f"aero card vs CPU: Xi rel {xi_rel}, {worst} "
                             f"rel {ch_rel[worst]}")
    xi_fu = np.abs(fu["Xi"] - leg["Xi"]).max() / np.abs(leg["Xi"]).max()
    print(f"phase aero main path: nw={model.nw} cases={leg['Xi'].shape[0]} "
          f"wind_cases={n_wind} trips={trips} legacy: gj_launches="
          f"{leg['launches']['gj_solve']} {split(leg['times'])} | "
          f"waterfall: bit_identical_to_legacy=True blocks={st['blocks']} "
          f"gj_launches={wf['launches']['gj_solve']} {split(wf['times'])} | "
          f"fused: flags_identical=True xi_rel_vs_legacy={xi_fu:.3e} "
          f"fused_launches={fu['launches']['fused_block']} gj_launches="
          f"{fu['launches']['gj_solve']} {split(fu['times'])} | "
          f"xi_rel_vs_cpu={xi_rel:.3e} worst_rotor_channel={worst} "
          f"rel={ch_rel[worst]:.3e} power_avg_MW="
          f"{np.round(leg['metrics']['power_avg'] / 1e6, 3).tolist()}",
          flush=True)
    return {m: out[m]["launches"] for m in out}


# ------------------------------------------------- bridles and ballast

def bridled_design(rt):
    return rt.designs.demo_semi_bridled(12, (0.00625, 0.8))


def bridled_phase(rt, Timers):
    """Phase 15: the bridled semi through Model on the card in the three
    fixed-point modes (one Model; each warm call with the launch counts
    set to 0 just before it), held against the same port run on the
    CPU."""
    from raft_tpu_torch.kernels import fused_block as fk
    from raft_tpu_torch.kernels import gj_solve as gk

    model = rt.Model(bridled_design(rt))
    model.analyze_unloaded()
    model.analyze_cases()
    out = {}
    for mode in ("legacy", "waterfall", "fused"):
        gk.launches = fk.launches = 0
        with Timers() as tm:
            with tm.time("analyze_cases"):
                model.analyze_cases(fixed_point=mode)
        out[mode] = dict(
            Xi=model.Xi.copy(), report=model.solve_report,
            launches=dict(gj_solve=gk.launches, fused_block=fk.launches),
            times={k: v["total_s"] for k, v in tm.report().items()},
            T={k: model.results["case_metrics"][k].copy()
               for k in ("Tmoor_avg", "Tmoor_std")})
    leg, wf, fu = out["legacy"], out["waterfall"], out["fused"]
    rep = leg["report"]
    if model.ms.bridles is None or leg["Xi"].shape != (12, 6, 128):
        raise AssertionError("the bridled design did not run")
    if not rep.converged.all() or not np.isfinite(leg["Xi"]).all():
        raise AssertionError(f"unhealthy bridled cases: {rep}")
    resid = float(np.max(model.moor_resid))
    if not resid < 1e-5:
        raise AssertionError(f"bridle junction residual {resid} >= 1e-5")
    if not (np.array_equal(wf["Xi"], leg["Xi"])
            and same_report(wf["report"], rep)):
        raise AssertionError("bridled waterfall is not bit-identical to "
                             "legacy")
    for f in ("converged", "iters", "nonfinite", "recovery_tier"):
        if not np.array_equal(getattr(fu["report"], f), getattr(rep, f)):
            raise AssertionError(f"bridled fused {f} differs from legacy")
    np.testing.assert_allclose(fu["Xi"], leg["Xi"], rtol=1e-8, atol=1e-12)
    cpu = rt.Model(bridled_design(rt), device="cpu")
    cpu.analyze_unloaded()
    cpu.analyze_cases()
    xi_rel = np.abs(leg["Xi"] - cpu.Xi).max() / np.abs(cpu.Xi).max()
    mc = cpu.results["case_metrics"]
    t_rel = max(np.abs(leg["T"][k] - mc[k]).max() / np.abs(mc[k]).max()
                for k in leg["T"])
    if not (xi_rel <= 1e-8 and t_rel <= 1e-8):
        raise AssertionError(f"bridled card vs CPU: Xi rel {xi_rel}, "
                             f"tension rel {t_rel}")
    print(f"phase bridled main path: nw={model.nw} cases=12 tension_"
          f"channels={leg['T']['Tmoor_avg'].shape[1]} moor_resid_max="
          f"{resid:.3e} legacy: gj_launches={leg['launches']['gj_solve']} "
          f"{split(leg['times'])} | waterfall: bit_identical_to_legacy=True "
          f"{split(wf['times'])} | fused: flags_identical=True "
          f"fused_launches={fu['launches']['fused_block']} "
          f"{split(fu['times'])} | xi_rel_vs_cpu={xi_rel:.3e} "
          f"tension_rel_vs_cpu={t_rel:.3e}", flush=True)
    return {m: out[m]["launches"] for m in out}


def _heave(model):
    st = model.statics
    sumFz = (-st.mass * model.g + st.V * model.rho_water * model.g
             + model.F_moor0[2])
    return sumFz / (model.rho_water * model.g * st.AWP)


def ballast_phase(rt):
    """Phase 16: analyze_unloaded(ballast=1 | 2) of the semi and the
    bridled semi on the card against the CPU: host work, equal bits."""
    parts = []
    for name, design in (("semi", flagship), ("bridled", bridled_design)):
        for ballast in (1, 2):
            got = []
            for device in (None, "cpu"):
                m = rt.Model(design(rt), device=device)
                m.analyze_unloaded(ballast=ballast)
                got.append(([np.atleast_1d(x.l_fill).tolist()
                             for x in m.members],
                            [np.atleast_1d(x.rho_fill).tolist()
                             for x in m.members], _heave(m)))
            if got[0] != got[1]:
                raise AssertionError(f"{name} ballast={ballast}: card and "
                                     f"CPU trims differ: {got}")
            parts.append(f"{name} ballast={ballast}: l_fill[0]="
                         f"{got[0][0][0]} rho_fill[0]={got[0][1][0]} "
                         f"heave={got[0][2]:.4e}")
    print("phase ballast: equal bits card/CPU; " + "; ".join(parts),
          flush=True)


# ------------------------------------------------------- the sweeps

# the headline sweep's grid: 16 x 16 as bench_sweep.py's, with ranges
# that keep the in-repo semi upright (bench_sweep.py's 0.85-1.15 x
# 0.25-1.75 are VolturnUS-S's; on this semi, ballast below ~1.1x leaves
# GMT near or below zero and mean pitches of tens of degrees): every
# design here has GMT > 3.5 m and a mean pitch within 5 degrees
DRAFTS = np.linspace(0.9, 1.1, 16)
BALLASTS = np.linspace(1.2, 1.8, 16)
CHECK_ROWS = ((0, 0), (7, 9), (15, 15))
# drafts per dynamics dispatch, and the rung its 4 x 16 x 12 = 768 lanes
# take
DRAFT_GROUP = 4
SWEEP_RUNG = 1024
# raft_tpu's CPU figure for its 256-design sweep of VolturnUS-S (PERF.md),
# printed for orientation only: another design on another machine
RAFT_TPU_CPU_MS_PER_DESIGN_VOLTURNUS = 263.97


class _Capture:
    """Wraps a kernel's entry: keeps a copy of the inputs of the first
    call whose argument ``arg`` has ``lanes`` rows (any count with None)
    and, with ``nodes``, whose node bundle (argument 0) has that many
    nodes; forwards every call."""

    def __init__(self, fn, lanes, arg=0, nodes=None):
        self.fn, self.lanes, self.arg, self.nodes = fn, lanes, arg, nodes
        self.args = self.kw = None

    def _wanted(self, args):
        return ((self.lanes is None
                 or args[self.arg].shape[0] == self.lanes)
                and (self.nodes is None
                     or args[0].r.shape[-2] == self.nodes))

    def __call__(self, *args, **kw):
        if self.args is None and self._wanted(args):
            clone = lambda a: a.clone() if isinstance(a, torch.Tensor) \
                else a  # noqa: E731
            self.args = tuple(tuple(clone(t) for t in a)
                              if isinstance(a, tuple)
                              else (type(a)(**{k: clone(v) for k, v in
                                               vars(a).items()})
                                    if hasattr(a, "submerged") else clone(a))
                              for a in args)
            self.kw = dict(kw)
        return self.fn(*args, **kw)


def _hold_captured(gk, fk, where, cap_gj=None, cap_fb=None):
    """Holds gj_solve and fused_block on the operands a run captured
    (:class:`_Capture`) against their plain versions: gj_solve bit for
    bit (NaN systems aside), fused_block with equal i / done / froze and
    amplitudes within 1e-12 of max|x|.  Returns {name: (rows, err)}."""
    checks = {}
    for name, cap in (("gj_solve", cap_gj), ("fused_block", cap_fb)):
        if cap is not None and cap.args is None:
            raise AssertionError(f"{name} never ran {where}")
    if cap_gj is not None:
        out_k, _ = gk.gj_solve(*cap_gj.args)
        out_p, _ = gk.gj_solve_reference(*cap_gj.args)
        torch.cuda.synchronize()
        fin = ~torch.isnan(out_p)
        if not (torch.equal(torch.isnan(out_k), ~fin)
                and torch.equal(out_k[fin], out_p[fin])):
            raise AssertionError(f"gj_solve {where} differs from its "
                                 "plain version")
        checks["gj_solve"] = (cap_gj.args[0].shape[0], 0.0)
    if cap_fb is not None:
        a, kw = cap_fb.args, cap_fb.kw
        out_k = fk.fused_block(*a, **kw)
        out_p = fk.fused_block_reference(*a, **kw)
        torch.cuda.synchronize()
        for k in (0, 4, 5):
            if not torch.equal(out_k[k], out_p[k]):
                raise AssertionError(f"fused_block {where}: output {k} "
                                     "differs from its plain version")
        err = max((out_k[k] - out_p[k]).abs().max().item()
                  for k in (1, 2, 3))
        x_max = max(out_p[k].abs().max().item() for k in (1, 2, 3))
        if not err <= 1e-12 * x_max:
            raise AssertionError(f"fused_block {where}: {err} > 1e-12 * "
                                 f"{x_max}")
        checks["fused_block"] = (a[1].shape[0], err)
    return checks


def _ballast_point(rt, design, draft, ballast):
    from raft_tpu_torch.sweep_fused import scale_draft

    d = scale_draft(design, draft)
    for mem in d["platform"]["members"]:
        rf = mem.get("rho_fill")
        if rf is not None:
            mem["rho_fill"] = ([float(x) * ballast for x in rf]
                               if isinstance(rf, (list, tuple))
                               else float(rf) * ballast)
    return d


def headline_sweep_phase(rt, card):
    """Phase 17: the 256-design draft x ballast sweep of the aero semi
    (12 cases x 128 w, six with wind) on the card, waterfall and fused,
    each draft group of 4 drafts x 16 ballasts x 12 cases one descent at
    the 1024-lane rung; three rows held against the direct Model; the
    kernels held against their plain versions on the sweep's own
    1024-lane operands; then both engines again with the case-axis
    overlap (overlap=True); and the guided rotor's guards at the sweep's
    scale (:func:`guided_rotor_check`)."""
    import raft_tpu_torch.dynamics as dyn
    import raft_tpu_torch.sweep_fused as sf
    import raft_tpu_torch.waterfall as wfm
    from raft_tpu_torch.kernels import fused_block as fk
    from raft_tpu_torch.kernels import gj_solve as gk

    base = aero_design(rt)
    # the host prep's thread count, measured where this runs: the sweep's
    # cold draft prep in order on one thread against a pool of 8
    from concurrent.futures import ThreadPoolExecutor

    from raft_tpu_torch.utils.placement import host_threads

    prep = lambda s: sf._prepare_draft(base, s, 1025.0, 9.81)  # noqa: E731
    prep_s = {}
    for workers in (1, 8):
        t0 = time.perf_counter()
        with host_threads(), ThreadPoolExecutor(workers) as ex:
            list(ex.map(prep, DRAFTS))
        prep_s[workers] = time.perf_counter() - t0
    runs = {}
    for mode, overlap in (("waterfall", "auto"), ("fused", "auto"),
                          ("waterfall", True), ("fused", True)):
        cap_gj = _Capture(dyn.gj_solve, SWEEP_RUNG * 128)
        cap_fb = _Capture(wfm.fused_block, SWEEP_RUNG, arg=1)
        dyn.gj_solve, wfm.fused_block = cap_gj, cap_fb
        gk.launches = fk.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            res = sf.run_draft_ballast_sweep(
                base, DRAFTS, BALLASTS, draft_group=DRAFT_GROUP,
                return_xi=True,
                verbose=False, fixed_point=mode, overlap=overlap)
        finally:
            dyn.gj_solve, wfm.fused_block = cap_gj.fn, cap_fb.fn
        total = time.perf_counter() - t0
        runs[(mode, overlap)] = dict(
            res=res, total=total, cap_gj=cap_gj, cap_fb=cap_fb,
            peak_gb=torch.cuda.max_memory_allocated() / 1e9,
            launches=dict(gj_solve=gk.launches, fused_block=fk.launches))
    wf, fu = runs[("waterfall", "auto")], runs[("fused", "auto")]
    r = wf["res"]
    if not r["converged"].any() or not np.isfinite(r["std"]).all():
        raise AssertionError("headline sweep unhealthy")
    if r["Xi"].shape != (len(DRAFTS), len(BALLASTS), 12, 6, 128):
        raise AssertionError(f"unexpected sweep shape {r['Xi'].shape}")
    st = r["dispatch_stats"]
    n_groups = len(DRAFTS) // DRAFT_GROUP
    if st["lanes_padded"] != n_groups * SWEEP_RUNG \
            or SWEEP_RUNG not in st["rungs"]:
        raise AssertionError(f"the sweep did not run the 1024 rung: {st}")
    for f in ("converged", "iters", "nonfinite", "recovery_tier"):
        if not np.array_equal(fu["res"][f], r[f]):
            raise AssertionError(f"sweep fused {f} differs from waterfall")
    for key in ("std", "Xi"):
        np.testing.assert_allclose(fu["res"][key], r[key], rtol=1e-8,
                                   atol=1e-12)
    # the case-chunked overlap (overlap=True) against one dispatch
    for mode, one in (("waterfall", wf), ("fused", fu)):
        np.testing.assert_allclose(runs[(mode, True)]["res"]["std"],
                                   one["res"]["std"], rtol=1e-12, atol=0)
    # three rows against the direct Model on the card (raft_tpu's bars,
    # tests/test_sweep_fused.py:84-170)
    for iD, iB in CHECK_ROWS:
        m = rt.Model(_ballast_point(rt, base, DRAFTS[iD], BALLASTS[iB]))
        m.analyze_unloaded()
        m.analyze_cases()
        if abs(r["mass"][iD, iB] - m.statics.mass) > 1e-12 * m.statics.mass:
            raise AssertionError(f"row {iD, iB}: mass differs")
        np.testing.assert_allclose(r["Xi0"][iD, iB],
                                   m.results["means"]["platform offset"],
                                   rtol=1e-6, atol=1e-10)
        np.testing.assert_allclose(np.abs(r["Xi"][iD, iB]), np.abs(m.Xi),
                                   rtol=2e-5, atol=1e-7)
    # the kernels on the sweep's own operands at its 1024-lane rung
    checks = _hold_captured(gk, fk, "at the sweep rung", wf["cap_gj"],
                            fu["cap_fb"])
    a = fu["cap_fb"].args
    G = fk.launch_shape(a[1].shape[1], a[1].shape[-1], a[1].dtype)[0]
    for (mode, overlap), run in runs.items():
        res = run["res"]
        tm, tel, st = res["timing"], res["rotor_telemetry"], \
            res["dispatch_stats"]
        pad = 1.0 - st["n_lanes"] / st["lanes_padded"]
        nd, nc, nw = res["Xi"].shape[0] * res["Xi"].shape[1], \
            res["Xi"].shape[2], res["Xi"].shape[-1]
        print(f"phase headline sweep {mode} overlap={overlap}: {card} "
              f"designs={nd} cases={nc} nw={nw} total_s={run['total']:.3f} "
              f"ms_per_design={1e3 * run['total'] / nd:.2f} split: "
              f"draft_prep_s={tm['host_prep_s']:.3f} rotor_s="
              f"{tm['aero_first_s'] + tm['aero_second_s']:.3f} mooring_s="
              f"{tm['mooring_s']:.3f} dynamics_s={tm['dynamics_first_s']:.3f}"
              f" overlap_saved_s={tm['overlap_saved_s']:.3f} chunks="
              f"{tm['overlap_chunks']} | launches gj_solve="
              f"{run['launches']['gj_solve']} fused_block="
              f"{run['launches']['fused_block']} rungs={st['rungs']} "
              f"padding_share={pad:.4f} | rotor guided_lanes="
              f"{tel['guided_lanes']} direct_fallback_lanes="
              f"{tel['direct_fallback_lanes']} sample_lanes="
              f"{tel['bracketed_sample_lanes']} | non_converged="
              f"{int((~res['converged']).sum())} retried="
              f"{int(res['retried'].sum())} | peak_device_GB="
              f"{run['peak_gb']:.3f}", flush=True)
    print(f"phase headline sweep checks: rows {list(CHECK_ROWS)} within "
          f"raft_tpu's bars of the direct Model; fused vs waterfall within "
          f"1e-8; kernels at the sweep rung: gj_solve {checks['gj_solve'][0]}"
          f" systems bit_identical=True, fused_block "
          f"{checks['fused_block'][0]} lanes x cluster {G} CTAs max_abs_err="
          f"{checks['fused_block'][1]:.3e}; cold draft prep 16 drafts: "
          f"1_thread_s={prep_s[1]:.3f} 8_threads_s={prep_s[8]:.3f}; "
          f"raft_tpu JAX-on-CPU VolturnUS-S figure for orientation only: "
          f"{RAFT_TPU_CPU_MS_PER_DESIGN_VOLTURNUS} ms/design", flush=True)
    guided_rotor_check(rt, base, card)
    return {mode: run["launches"] for (mode, ov_), run in runs.items()
            if ov_ == "auto"}


def guided_rotor_check(rt, base, card):
    """The guided rotor's guards at the headline's scale: 256 designs x
    the six wind cases.  Cases 1, 3 and 5 take mean pitches spread as on
    bench_sweep.py's own grid of this semi (up to 1.9 rad: the warm start
    must fall back to the direct solve), cases 2, 4 and 6 pitches within
    5 degrees (guided); every lane against the direct evaluation, the
    fallback lanes to 1e-12 and the guided ones to the CPU test's bars
    (1e-10 on the loads, 1e-9 on the derivatives)."""
    import raft_tpu_torch.sweep_fused as sf
    from raft_tpu_torch.io.schema import cases_as_dicts
    from raft_tpu_torch.utils.placement import host_threads

    m = rt.Model(base)
    cases = cases_as_dicts(base)
    wind = m._case_arrays(cases)[4]
    widx = np.where(wind > 0.0)[0]
    U = wind[widx]
    yaw = np.array([float(cases[i].get("yaw_misalign", 0.0))
                    for i in widx])
    nd, nwind = len(DRAFTS) * len(BALLASTS), len(widx)
    rng = np.random.default_rng(17)
    pitch = rng.uniform(-0.02, 0.08, (nd, nwind))
    wide = np.arange(0, nwind, 2)
    pitch[:, wide] = rng.uniform(0.0, 1.9, (nd, len(wide)))
    tel = sf._blank_rotor_telemetry()
    with host_threads():
        t0 = time.perf_counter()
        v_g, J_g = sf._guided_rotor_eval(m.rotor, U, yaw, pitch, tel)
        t_guided = time.perf_counter() - t0
        v_d, J_d = m.rotor.run_bem_batch(
            np.broadcast_to(U[None], (nd, nwind)).ravel(), pitch.ravel(),
            np.broadcast_to(yaw[None], (nd, nwind)).ravel())
    v_d, J_d = v_d.reshape(nd, nwind, 10), J_d.reshape(nd, nwind, 10, 3)
    if tel["direct_fallback_lanes"] != nd * len(wide) \
            or tel["guided_lanes"] != nd * (nwind - len(wide)):
        raise AssertionError(f"guided rotor lane accounting: {tel}")
    errs = []
    for j in range(nwind):
        sv = np.abs(v_d[:, j]).max(axis=0) + 1e-30
        sj = np.abs(J_d[:, j]).max(axis=0) + 1e-30
        ev = float((np.abs(v_g[:, j] - v_d[:, j]) / sv).max())
        ej = float((np.abs(J_g[:, j] - J_d[:, j]) / sj).max())
        bars = (1e-12, 1e-12) if j in wide else (1e-10, 1e-9)
        if not (ev <= bars[0] and ej <= bars[1]):
            raise AssertionError(f"guided rotor case {j}: {ev}, {ej}")
        errs.append(max(ev, ej))
    print(f"phase headline sweep guided rotor: {card} lanes={nd * nwind} "
          f"guided_lanes={tel['guided_lanes']} direct_fallback_lanes="
          f"{tel['direct_fallback_lanes']} fallback_cases="
          f"{tel['fallback_cases']} max_rel_err_vs_direct="
          f"{max(errs):.3e} guided_eval_s={t_guided:.3f}", flush=True)


def _sweep_point(design, point):
    """tests/test_sweep.py's point: outer-column diameter and draft."""
    for mem in design["platform"]["members"]:
        if mem["name"] == "outer":
            mem["d"] = [point["d_col"]] * len(np.atleast_1d(mem["d"]))
        mem["rA"][2] *= point["draft_scale"]
        if mem["rB"][2] < 0:
            mem["rB"][2] *= point["draft_scale"]
    return design


def general_sweeps_phase(rt, card):
    """Phase 18: run_design_sweep on 16 bridled semis (main leg 750-780
    m) with the density trim, held against the direct Model; run_sweep on
    the demo semi's 6-point grid into a checkpoint directory and again
    from the checkpoints, bit-identical."""
    import tempfile

    from raft_tpu_torch.kernels import fused_block as fk
    from raft_tpu_torch.kernels import gj_solve as gk
    from raft_tpu_torch.sweep import grid_points, run_sweep
    from raft_tpu_torch.sweep_fused import run_design_sweep

    lengths = np.linspace(750.0, 780.0, 16)
    designs = [rt.designs.demo_semi_bridled(12, (0.00625, 0.8), L)
               for L in lengths]
    gk.launches = fk.launches = 0
    t0 = time.perf_counter()
    res = run_design_sweep(designs, return_xi=True, verbose=False,
                           trim_ballast_density=True)
    t_design = time.perf_counter() - t0
    launches = dict(gj_solve=gk.launches, fused_block=fk.launches)
    if not (res["moor_resid"] < 1e-5).all():
        raise AssertionError("bridle junction residual >= 1e-5 in the "
                             "design sweep")
    models = [rt.Model(d) for d in designs]
    for i, m in enumerate(models):
        delta = m.adjust_ballast_density()
        if abs(res["delta_rho"][i] - delta) > 1e-6 * abs(delta):
            raise AssertionError(f"design {i}: delta_rho "
                                 f"{res['delta_rho'][i]} vs {delta}")
    for i in (0, 8, 15):
        m = models[i]
        m.analyze_unloaded()
        args, aux = m.prepare_case_inputs(verbose=False)
        m.analyze_cases()
        np.testing.assert_allclose(res["Xi0"][i], aux["Xi0"], rtol=1e-8,
                                   atol=1e-10)
        np.testing.assert_allclose(res["T_moor"][i], aux["T_moor"],
                                   rtol=1e-8)
        np.testing.assert_allclose(np.abs(res["Xi"][i]), np.abs(m.Xi),
                                   rtol=2e-5, atol=1e-7)
    axes = {"d_col": [9.0, 10.0, 11.0], "draft_scale": [1.0, 1.1]}
    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.perf_counter()
        s1 = run_sweep(rt.designs.demo_semi(n_cases=2), grid_points(axes),
                       _sweep_point, out_dir=out_dir, verbose=False)
        t_sweep = time.perf_counter() - t0
        s2 = run_sweep(rt.designs.demo_semi(n_cases=2), grid_points(axes),
                       _sweep_point, out_dir=out_dir, verbose=False)
    for key in ("Xi", "mass", "iters", "converged", "residual", "cond"):
        if not np.array_equal(s1[key], s2[key]):
            raise AssertionError(f"run_sweep restart differs in {key}")
    if not s1["converged"].all():
        raise AssertionError("run_sweep points did not converge")
    tm = res["timing"]
    print(f"phase general sweeps: {card} design_sweep bridled x16 trimmed "
          f"total_s={t_design:.3f} (prep {tm['host_prep_s']:.3f}, mooring "
          f"{tm['mooring_s']:.3f}, dynamics {tm['dynamics_first_s']:.3f}) "
          f"delta_rho={np.round(res['delta_rho'][[0, 15]], 3).tolist()} "
          f"gj_launches={launches['gj_solve']} moor_resid_max="
          f"{res['moor_resid'].max():.3e} | run_sweep 6 points total_s="
          f"{t_sweep:.3f} restart_bit_identical=True", flush=True)
    return launches


# ------------------------------------------- gradients and batched prep

# the card the gradient and batched-prep phases run on
CARD = "cuda"
# phase 21's column-diameter scales (its drafts are phase 17's DRAFTS)
DIAMETERS = np.linspace(0.9, 1.1, 16)

def gj_backward_phase(gk, dtype):
    """Phase 19: GaussSolve's backward at the main path's [1536, 12, 13]:
    lam = A^-T g by one backward launch of the kernel on [A^T | g], then
    A_bar = -lam x^T and b_bar = lam, against the plain version's
    backward (the plain elimination of the same transposed systems on the
    card) within 1e-12 max|x| in float64 (1e-5 in float32; the same bits
    are expected); gradcheck on a small float64 batch; the backward's
    call and device times, its bound (bytes of [A^T | g] in and lam out,
    the elimination's operations) and torch.linalg.solve's backward."""
    from raft_tpu_torch.dynamics import GaussSolve

    g = torch.Generator().manual_seed(19)
    A = torch.randn(B, N, N, generator=g, dtype=torch.float64) \
        + N * torch.eye(N, dtype=torch.float64)
    A[100:164] = A[100:164].roll(1, dims=1)      # row swaps at every step
    b = torch.randn(B, N, 1, generator=g, dtype=torch.float64)
    c = torch.randn(B, N, 1, generator=g, dtype=torch.float64)
    A, b, c = (t.to(CARD, dtype) for t in (A, b, c))
    A.requires_grad_(True)
    b.requires_grad_(True)
    x = GaussSolve.apply(A, b)
    n0 = gk.launches_backward
    gA, gb = torch.autograd.grad(x, (A, b), c, retain_graph=True)
    torch.cuda.synchronize()
    if gk.launches_backward != n0 + 1:
        raise AssertionError("the backward did not launch the kernel once")
    At = torch.cat([A.detach().transpose(-1, -2), c], -1).contiguous()

    def plain():
        lam = gk.gj_solve_reference(At)[0][..., N:]
        return -lam @ x.detach().transpose(-1, -2), lam

    pA, pb = plain()
    err = max((gA - pA).abs().max().item(), (gb - pb).abs().max().item())
    bits = torch.equal(gA, pA) and torch.equal(gb, pb)
    tol = (1e-12 if dtype == torch.float64 else 1e-5) \
        * x.detach().abs().max().item()
    if not err <= tol:
        raise AssertionError(f"{dtype}: backward max|d| {err} > {tol}")
    gc = True
    if dtype == torch.float64:
        A6 = (torch.randn(4, 6, 6, generator=g, dtype=torch.float64)
              + 6 * torch.eye(6, dtype=torch.float64)).to(CARD)
        b6 = torch.randn(4, 6, 1, generator=g, dtype=torch.float64).to(CARD)
        gc = torch.autograd.gradcheck(
            GaussSolve.apply, (A6.requires_grad_(), b6.requires_grad_()))
    ms = cuda_ms(lambda: torch.autograd.grad(x, (A, b), c,
                                             retain_graph=True), 100)
    device_ms = graph_ms(lambda: gk.gj_solve(At, backward=True), 50)
    plain_ms = cuda_ms(plain, 20)
    A2 = A.detach().clone().requires_grad_(True)
    b2 = b.detach().clone().requires_grad_(True)
    x2 = torch.linalg.solve(A2, b2)
    library_ms = cuda_ms(lambda: torch.autograd.grad(
        x2, (A2, b2), c, retain_graph=True), 50)
    item = torch.finfo(dtype).bits // 8
    bound_ms, bound_by = bound((B * N * M + B * N) * item,
                               B * N * (M + 2 * (N - 1) * M), dtype)
    print(f"phase gj_solve backward {dtype_name(dtype)}: [{B},{N},{M}] "
          f"[A^T|g] bit_identical={bits} max_abs_err={err:.3e} "
          f"tol={tol:.3e} gradcheck={gc} ms={ms:.5f} "
          f"device_ms={device_ms:.5f} plain_ms={plain_ms:.5f} "
          f"library_ms={library_ms:.5f} (torch.linalg.solve backward) "
          f"bound_ms={bound_ms:.6f} ({bound_by})", flush=True)
    return dict(backward_max_abs_err=err, backward_ms=ms,
                backward_device_ms=device_ms, backward_plain_ms=plain_ms,
                backward_library_ms=library_ms, backward_bound_ms=bound_ms,
                backward_bound_by=bound_by)


FD_EPS = 1e-4


def _fd_stencil(f, metrics):
    """Finite-difference derivatives of ``f``'s metrics in each parameter
    at theta0: central differences, one-sided second-order ones for the
    draft (theta_draft = 1 sits on a kink of the semi, a waterline clip
    that switches, as in raft_tpu's tests/test_grad.py), each taken at
    eps = 1e-4 and 5e-5 and Richardson-extrapolated, (4 D(eps/2) -
    D(eps)) / 3, so that the stencil's own error (eps^2 times the third
    derivative, large at the RAO peak of the 128-frequency grid) drops
    to eps^4.  Returns (values at theta0, {metric: [d/dparam]})."""
    from raft_tpu_torch.utils.placement import host_threads

    def at(i, s):
        th = torch.ones(4, dtype=torch.float64)
        th[i] += s
        with torch.no_grad():
            return {k: float(v) for k, v in f(th).items()}

    with host_threads():
        v0 = at(0, 0.0)
        pts = {(i, m * h): at(i, m * h * FD_EPS) for i in range(4)
               for h in (1.0, 0.5) for m in ((1, -1, 2) if i == 0
                                               else (1, -1))}

    def D(k, i, h):
        p, m = pts[(i, h)][k], pts[(i, -h)][k]
        if i == 0:
            return (-3.0 * v0[k] + 4.0 * p - pts[(i, 2 * h)][k]) \
                / (2 * h * FD_EPS)
        return (p - m) / (2 * h * FD_EPS)

    fd = {k: [(4.0 * D(k, i, 0.5) - D(k, i, 1)) / 3.0 for i in range(4)]
          for k in metrics}
    return v0, fd


def design_gradients_phase(rt, card):
    """Phase 20: exact design gradients on the card.  On the flagship
    (128 w x 12 cases plus the unit-wave case) and the aero design:
    design_gradients with the dynamics on the card against the same on
    the CPU (values 1e-10, Jacobian 1e-8 relative) and against central
    differences of the port's own response on the card (1e-4, raft_tpu's
    bar); then design_value_and_grad (the implicit adjoints) for
    rao_pitch_peak and pitch_max_deg: the value equal to f(theta0) on the
    card bit for bit, the gradient within 5e-3 of the differences; one
    lane with an injected NaN gives an all-zero gradient and the
    nonfinite flag.  Times, the host/device split, the adjoint trips and
    the gj_solve launches forward and backward."""
    from raft_tpu_torch import parametric as tp
    from raft_tpu_torch.grad import design_value_and_grad
    from raft_tpu_torch.grad import fixed_point as tfp
    from raft_tpu_torch.kernels import gj_solve as gk
    from raft_tpu_torch.utils.placement import host_threads

    names = tp.PARAM_NAMES
    launches = {}
    for label, design in (("flagship", flagship(rt)),
                          ("aero", aero_design(rt))):
        t0 = time.perf_counter()
        v_cpu, j_cpu = tp.design_gradients(design, device="cpu")
        t_cpu = time.perf_counter() - t0
        with host_threads():
            f, th0 = tp.build_design_response(design)
            with torch.no_grad():
                f(th0)                     # warm: the card's first call
            gk.launches = gk.launches_backward = 0
            t0 = time.perf_counter()
            th = th0.clone().requires_grad_(True)
            vals = f(th)
            t_fwd = time.perf_counter() - t0
            split = dict(tp.timing)
            fwd_launches = gk.launches
            t0 = time.perf_counter()
            jac = {}
            for j, k in enumerate(vals):
                (gk_,) = torch.autograd.grad(vals[k], th,
                                             retain_graph=j < len(vals) - 1,
                                             allow_unused=True)
                jac[k] = [0.0] * 4 if gk_ is None else gk_.tolist()
            t_bwd = time.perf_counter() - t0
        launches[label] = dict(gj_solve=fwd_launches,
                               gj_solve_backward=gk.launches_backward)
        worst_v = worst_j = worst_fd = 0.0
        for k, v in vals.items():
            v = float(v.detach())
            worst_v = max(worst_v, abs(v - v_cpu[k]) / abs(v_cpu[k]))
            for i, p in enumerate(names):
                ref = j_cpu[k][p]
                scale = max(abs(ref), 1e-9 * abs(v))
                worst_j = max(worst_j, abs(jac[k][i] - ref) / scale)
        if not (worst_v <= 1e-10 and worst_j <= 1e-8):
            raise AssertionError(f"{label}: card vs CPU values {worst_v:.3e}"
                                 f" Jacobian {worst_j:.3e}")
        v0, fd = _fd_stencil(f, list(vals))
        for k in vals:
            for i, p in enumerate(names):
                scale = abs(fd[k][i]) + 1e-9 * max(abs(v0[k]), 1.0)
                rel = abs(jac[k][i] - fd[k][i]) / scale
                worst_fd = max(worst_fd, rel)
                if rel > 1e-4:
                    raise AssertionError(
                        f"{label} {k} {p}: reverse {jac[k][i]} vs central "
                        f"difference {fd[k][i]} (rel {rel:.3e})")
        print(f"phase design gradients {label}: {card} metrics="
              f"{len(vals)} x params=4 forward_s={t_fwd:.3f} (host "
              f"{split['host_s']:.3f}, dynamics {split['dynamics_s']:.3f})"
              f" backward_s={t_bwd:.3f} cpu_port_s={t_cpu:.3f} "
              f"gj_launches forward={fwd_launches} backward="
              f"{gk.launches_backward} values_rel_vs_cpu={worst_v:.3e} "
              f"jacobian_rel_vs_cpu={worst_j:.3e} worst_rel_vs_central_"
              f"differences={worst_fd:.3e}", flush=True)
        for metric in ("rao_pitch_peak", "pitch_max_deg"):
            gk.launches = gk.launches_backward = 0
            t0 = time.perf_counter()
            value, grad = design_value_and_grad(design, metric)
            t_vg = time.perf_counter() - t0
            if value != v0[metric]:
                raise AssertionError(f"{label} {metric}: value {value!r} is "
                                     f"not f(theta0)'s {v0[metric]!r}")
            worst = 0.0
            for i, p in enumerate(names):
                ref = fd[metric][i]
                rel = abs(grad[p] - ref) / max(abs(ref), 1e-12)
                worst = max(worst, rel)
                if rel > 5e-3:
                    raise AssertionError(
                        f"{label} {metric} {p}: adjoint {grad[p]} vs "
                        f"central difference {ref}")
            launches[f"{label}_{metric}"] = dict(
                gj_solve=gk.launches, gj_solve_backward=gk.launches_backward)
            print(f"phase design gradients {label} value_and_grad {metric}:"
                  f" value_bit_identical=True total_s={t_vg:.3f} "
                  f"polish_trips={tfp.stats['polish']} adjoint_trips="
                  f"{tfp.stats['adjoint']} gj_launches forward="
                  f"{gk.launches} backward={gk.launches_backward} "
                  f"worst_rel_vs_central_differences={worst:.3e}",
                  flush=True)
    nan_lane_check(rt)
    return launches


def nan_lane_check(rt):
    """The flagship's case operands on the card through the implicit
    dynamics rule with lane 1's forcing poisoned: the lane quarantines
    (nonfinite) and its gradient is exactly zero; the others finite."""
    from raft_tpu_torch.grad import implicit_solve_dynamics
    from raft_tpu_torch.model import make_case_phases

    m = rt.Model(flagship(rt))
    m.analyze_unloaded()
    args, _ = m.prepare_case_inputs(verbose=False)
    args = tuple(torch.as_tensor(a, device=CARD) for a in args)
    prelude, _ = make_case_phases(m.w, m.k, m.depth, m.rho_water, m.g,
                                  m.XiStart, m.nIter, torch.float64, CARD)
    nodes = m.nodes.to(CARD, torch.float64)
    u, Fr, Fi = prelude(nodes, args[0], args[1], args[5], args[6])
    Fr = Fr.clone()
    Fr[1, 0, 0] = float("nan")
    Fr.requires_grad_(True)
    w = torch.as_tensor(m.w, device=CARD)
    xr, xi, rep = implicit_solve_dynamics(
        nodes, u, w, float(m.dw), m.rho_water, args[3], args[4], args[2],
        Fr, Fi, m.XiStart)
    keep = torch.ones(xr.shape[0], dtype=torch.bool, device=CARD)
    keep[1] = False
    (g,) = torch.autograd.grad(xr[keep].sum() + xi[keep].sum()
                               + torch.nan_to_num(xr[1]).sum(), Fr)
    flags = rep.nonfinite.tolist()
    if not (flags[1] and not any(flags[:1] + flags[2:])
            and bool((g[1] == 0).all()) and bool(torch.isfinite(g).all())
            and bool((g[0] != 0).any())):
        raise AssertionError(f"NaN lane: flags {flags}, lane-1 gradient "
                             f"zero {bool((g[1] == 0).all())}")
    print(f"phase design gradients nan lane: lanes={len(flags)} nonfinite="
          f"{[i for i, f in enumerate(flags) if f]} lane1_gradient_all_zero"
          f"=True others_finite=True", flush=True)


def batched_prep_phase(rt, card):
    """Phase 21: 256 unbridled flagship designs (apply_design_scales over
    16 drafts 0.9-1.1 x 16 column diameters 0.9-1.1, 12 cases x 128 w):
    PrepFamily.prepare on the card against solo prep (a Model each;
    raft_tpu's round-off bars: nodes 1e-9, args rtol 1e-6 / atol 1e-7 of
    their scale), bits equal across block compositions (one lane alone,
    the full block, a shuffled block), the geometry program on the card
    against device="cpu" on the same machine, then run_design_sweep with
    batched_prep=True against False (every result within 1e-10)."""
    from raft_tpu_torch.batched_prep import PrepFamily, PrepFamilyError
    from raft_tpu_torch.kernels import fused_block as fk
    from raft_tpu_torch.kernels import gj_solve as gk
    from raft_tpu_torch.parametric import apply_design_scales
    from raft_tpu_torch.sweep import _prepare_design
    from raft_tpu_torch.sweep_fused import run_design_sweep

    base = flagship(rt)
    designs = [apply_design_scales(base, [s, 1.0, c, 1.0])
               for s in DRAFTS for c in DIAMETERS]
    nd = len(designs)
    fam = PrepFamily(base)
    t0 = time.perf_counter()
    lanes, idx = [], []
    for i, d in enumerate(designs):
        try:
            lanes.append(fam.extract(d))
            idx.append(i)
        except PrepFamilyError:
            pass
    t_extract = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = fam.prepare(lanes)
    t_batched = time.perf_counter() - t0
    t0 = time.perf_counter()
    solo = [_prepare_design(designs[i], None, lambda d, _p: d, None, CARD)
            for i in idx]
    t_solo = time.perf_counter() - t0
    worst_n = worst_a = 0.0
    for (_, n_b, a_b), (_, n_s, a_s) in zip(out, solo):
        for f in n_s.__dataclass_fields__:
            x, y = getattr(n_b, f), getattr(n_s, f)
            if y.dtype == torch.bool:
                if not torch.equal(x, y):
                    raise AssertionError(f"batched prep mask {f} differs")
                continue
            worst_n = max(worst_n, (x - y).abs().max().item())
            if not torch.allclose(x, y, rtol=1e-9, atol=1e-9):
                raise AssertionError(f"batched prep nodes {f} drifted")
        for x, y in zip(a_b, a_s):
            scale = max(1.0, float(np.abs(y).max()) if y.size else 1.0)
            worst_a = max(worst_a, float(np.abs(x - y).max()) / scale)
            if not np.allclose(x, y, rtol=1e-6, atol=1e-7 * scale):
                raise AssertionError("batched prep args drifted")

    def same(a, b):
        return (all(torch.equal(getattr(a[1], f), getattr(b[1], f))
                    for f in a[1].__dataclass_fields__)
                and all(np.array_equal(x, y) for x, y in zip(a[2], b[2])))

    k = min(5, len(lanes) - 1)
    order = [k, 0, len(lanes) - 1, 1]
    if not (same(fam.prepare([lanes[k]])[0], out[k])
            and all(same(o, out[j]) for j, o in zip(
                order, fam.prepare([lanes[j] for j in order])))):
        raise AssertionError("batched prep bits depend on the block")
    geo_t = {}
    for dev, blk in ((CARD, 8), ("cpu", 8), (CARD, 64)):
        geo = PrepFamily(base, geometry_only=True, device=dev, block=blk)
        glanes = [geo.extract(designs[i]) for i in idx]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        geo.prepare_geometry(glanes)
        torch.cuda.synchronize()
        geo_t[(dev, blk)] = time.perf_counter() - t0

    # host prep and batched prep in turns (host, batched, batched, host)
    runs = {False: [], True: []}
    for flag in (False, True, True, False):
        gk.launches = fk.launches = 0
        t0 = time.perf_counter()
        res = run_design_sweep(designs, verbose=False, batched_prep=flag)
        runs[flag].append((res, time.perf_counter() - t0, gk.launches))
    off, on = runs[False][0][0], runs[True][0][0]
    worst = 0.0
    # the final solve's relative residual is round-off either way: both
    # below 1e-10, not held to each other
    if not (on["residual"].max() < 1e-10 and off["residual"].max() < 1e-10):
        raise AssertionError("design sweep residuals above 1e-10")
    for key, v in off.items():
        if key != "residual" and isinstance(v, np.ndarray) \
                and v.dtype.kind in "fc":
            d = float(np.abs(on[key] - v).max()) / max(
                float(np.abs(v).max()), 1e-300)
            worst = max(worst, d)
            if d > 1e-10:
                raise AssertionError(f"design sweep {key} batched vs host "
                                     f"prep {d:.3e}")
    print(f"phase batched prep: {card} designs={nd} family={len(lanes)} "
          f"refused={nd - len(lanes)} block={fam.block} extract_s="
          f"{t_extract:.3f} prepare_s={t_batched:.3f} ("
          f"{1e3 * t_batched / len(lanes):.3f} ms/design) solo_prep_s="
          f"{t_solo:.3f} ({1e3 * t_solo / len(lanes):.3f} ms/design) "
          f"nodes_max_abs_diff={worst_n:.3e} args_max_rel_diff="
          f"{worst_a:.3e} bits_across_blocks=True geometry_program "
          f"card_s={geo_t[(CARD, 8)]:.3f} cpu_s={geo_t[('cpu', 8)]:.3f} "
          f"card_block64_s={geo_t[(CARD, 64)]:.3f}", flush=True)
    for flag in (False, True):
        for turn, (res, total, gl) in enumerate(runs[flag]):
            print(f"phase batched prep sweep batched_prep={flag} turn "
                  f"{turn}: {card} designs={nd} total_s={total:.3f} "
                  f"ms_per_design={1e3 * total / nd:.3f} host_prep_s="
                  f"{res['timing']['host_prep_s']:.3f} prep_ms_per_design="
                  f"{1e3 * res['timing']['host_prep_s'] / nd:.3f} "
                  f"n_prep_batched={res['n_prep_batched']} n_prep_solo="
                  f"{res['n_prep_solo']} gj_launches={gl} "
                  f"max_rel_vs_host_prep={worst:.3e}", flush=True)
    return dict(gj_solve=runs[True][0][2])


# ------------------------------------------------------ BEM kernels

def tile_inv_phase(bg, dtype, tol):
    """One [N_TILE, N_TILE] pivot tile whose diagonal is zero and whose
    subdiagonal dominates: a row swap at every step."""
    n = N_TILE
    rng = np.random.default_rng(3)
    A = rng.standard_normal((n, n)) + n * np.eye(n)
    A[np.arange(n), np.arange(n)] = 0.0
    A += np.roll(np.eye(n), 1, axis=0) * n
    At = torch.as_tensor(A, dtype=dtype, device="cuda")
    inv = bg.tile_inv(At)
    ref = bg.tile_inv_reference(At)
    torch.cuda.synchronize()
    err = (inv - ref).abs().max().item()
    x_max = ref.abs().max().item()
    if not torch.equal(inv, ref):
        raise AssertionError(
            f"{dtype}: tile_inv differs from its plain version: max|d| {err}"
            f" (bits expected equal; {tol:g} * max|x| = {tol * x_max:.3e})")
    cluster, smem = bg.tile_inv_launch_shape(n, dtype)
    resid = (inv.double() @ At.double()
             - torch.eye(n, dtype=torch.float64, device="cuda")).abs().max()
    ms = cuda_ms(lambda: bg.tile_inv(At), 20)
    plain_ms = cuda_ms(lambda: bg.tile_inv_reference(At), 2, 1)
    library_ms = cuda_ms(lambda: torch.linalg.inv(At), 20)
    # the tile read once and the inverse written once; the 2 n^3
    # operations an inverse needs (the elimination on [A | I] does 4 n^3),
    # at the product rate (a blocked inverse is made of products)
    item = torch.finfo(dtype).bits // 8
    bound_ms, bound_by = bound(2 * n * n * item, 2 * n ** 3, dtype, True)
    simt_ms, _ = bound(2 * n * n * item, 2 * n ** 3, dtype)
    print(f"phase tile_inv kernel {dtype_name(dtype)}: [{n},{n}] cluster="
          f"{cluster} CTAs smem_per_cta={smem} B, row swaps at every step "
          f"bit_identical=True max_abs_err={err:.3e} |inv@A-I|="
          f"{resid.item():.2e} ms={ms:.5f} plain_ms={plain_ms:.3f} "
          f"library_ms={library_ms:.5f} bound_ms={bound_ms:.6f} "
          f"({bound_by}; at the {PEAK_FLOPS[dtype] / 1e12:.0f} TFLOP/s "
          f"non-product rate {simt_ms:.6f})", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)


# the products of one folded elimination step at 2N = 5120, pivot block
# 512, 6 radiation modes + 1 heading padded to 8 (kernels/bem_gj.py
# gj_stage holds [A | b] as one [5120, 5128] buffer)
MM_SHAPES = (("Dinv@[D|Db]", "mm", 512, 512, 5128),
             ("[A|b]-C@row", "mm_sub", 5120, 512, 5128))


def mm_phase(bg, dtype):
    """Each product against its plain version (``L @ R``, ``X - L @ R``)
    within the accumulated rounding K eps max(|L| @ |R|); cuBLAS as the
    yardstick.  For ``mm`` the plain version on the card is the library
    call itself (``L @ R`` is ``torch.matmul``), timed once and recorded
    as both; for ``mm_sub`` the library call is the one fused cuBLAS call
    ``torch.addmm(X, L, R, alpha=-1)``.  Returns the numbers of each
    shape, with the path's two kernels' entries."""
    g = torch.Generator(device="cuda").manual_seed(5)
    item = torch.finfo(dtype).bits // 8
    out = {}
    for name, kernel, M, K, N in MM_SHAPES:
        L, R, X = (torch.randn(*shape, generator=g, device="cuda",
                               dtype=dtype)
                   for shape in ((M, K), (K, N), (M, N)))
        if kernel == "mm":
            run = lambda: bg.mm(L, R)                       # noqa: E731
            plain = lambda: bg.mm_reference(L, R)           # noqa: E731
            library = None
            nbytes = (M * K + K * N + M * N) * item
        else:
            run = lambda: bg.mm_sub(X, L, R)                # noqa: E731
            plain = lambda: bg.mm_sub_reference(X, L, R)    # noqa: E731
            library = lambda: torch.addmm(X, L, R, alpha=-1)  # noqa: E731
            nbytes = (M * K + K * N + 2 * M * N) * item
        err = (run() - plain()).abs().max().item()
        tol = K * torch.finfo(dtype).eps * (L.abs() @ R.abs()).max().item()
        if not err <= tol:
            raise AssertionError(f"{dtype} {name}: {kernel} vs plain max|d| "
                                 f"{err} > K eps max(|L|@|R|) = {tol}")
        flops = 2 * M * K * N
        ms = cuda_ms(run, 20)
        plain_ms = cuda_ms(plain, 20)
        library_ms = plain_ms if library is None else cuda_ms(library, 20)
        bound_ms, bound_by = bound(nbytes, flops, dtype, True)
        simt_ms, _ = bound(nbytes, flops, dtype)
        print(f"phase {kernel} kernel {dtype_name(dtype)} {name}: "
              f"[{M},{K}]x[{K},{N}] max_abs_err={err:.3e} (bar {tol:.3e}) "
              f"ms={ms:.5f} plain_ms={plain_ms:.5f} library_ms="
              f"{library_ms:.5f} bound_ms={bound_ms:.6f} ({bound_by}, "
              f"{PEAK_PRODUCT_FLOPS[dtype] / 1e12:.0f} TFLOP/s; at the "
              f"{PEAK_FLOPS[dtype] / 1e12:.0f} TFLOP/s non-tensor-core rate "
              f"{simt_ms:.6f}) tflops={flops / ms / 1e9:.2f}", flush=True)
        out[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         library_ms=library_ms, bound_ms=bound_ms,
                         bound_by=bound_by)
    return dict(mm=out["Dinv@[D|Db]"], mm_sub=out["[A|b]-C@row"], shapes=out)


# ----------------------------------------------------------- BEM path

def bem_design(rt):
    """The flagship with every member potential-flow (potModMaster = 2)."""
    design = flagship(rt)
    design["platform"]["potModMaster"] = 2
    return design


def cheb_forms_phase(tb, panels, lids, omega, g):
    """The wave term's Chebyshev evaluation at the first assembly row block
    of the BEM mesh at ``omega``, in the port's gathered form (each pair on
    its own region's patch, a device-to-host sync per region) and in
    raft_tpu's masked form (all six patches at every pair, no sync): the
    two agree, and both are timed."""
    from raft_tpu_torch import greens

    pa = tb.pad_panel_arrays(tb._concat_panel_arrays(
        tb.panel_arrays(panels), tb.panel_arrays(lids)))
    N, Q = pa.qpts.shape[:2]
    rb = tb._row_block(N, Q, True)
    x = torch.as_tensor(pa.cen[:rb], dtype=torch.float32, device="cuda")
    y = torch.as_tensor(pa.qpts, dtype=torch.float32, device="cuda")
    nu = omega * omega / g
    Rh = torch.sqrt((x[:, None, None, 0] - y[None, :, :, 0]) ** 2
                    + (x[:, None, None, 1] - y[None, :, :, 1]) ** 2)
    a = nu * Rh
    b = torch.clamp(nu * (x[:, None, None, 2] + y[None, :, :, 2]),
                    max=-1e-9)
    C = {k: torch.as_tensor(v, device="cuda")
         for k, v in greens.load_cheb_tables().items()}
    gathered = greens.eval_F_F1_cheb(a, b, C)
    masked = greens.eval_F_F1_cheb(a, b, C, masked=True)
    gap = max(((m - g_).abs().max() / g_.abs().max()).item()
              for m, g_ in zip(masked, gathered))
    if not gap <= 5e-6:
        raise AssertionError(f"Chebyshev forms differ by {gap:.3e}")
    ms = cuda_ms(lambda: greens.eval_F_F1_cheb(a, b, C), 5, 1)
    masked_ms = cuda_ms(lambda: greens.eval_F_F1_cheb(a, b, C, masked=True),
                        5, 1)
    blocks = N // rb
    print(f"phase bem cheb forms: w={omega:.4f} block=[{rb},{N},{Q}] "
          f"({a.numel()} pairs) blocks_per_frequency={blocks} "
          f"gathered_ms={ms:.3f} masked_ms={masked_ms:.3f} per frequency "
          f"gathered_ms={blocks * ms:.1f} masked_ms={blocks * masked_ms:.1f} "
          f"max_rel_gap={gap:.2e}", flush=True)


def bem_phase(rt, bg, gk, fk, Timers, ti, mm):
    """Model(design).run_bem() on the card at the design's default panel
    sizes, with the kernels' launch counts set to 0 just before it; one
    solved frequency held against the same card form on the CPU."""
    from raft_tpu_torch import bem_solver as tb
    from raft_tpu_torch import mesh

    model = rt.Model(bem_design(rt))
    model.analyze_unloaded()
    bg.reset_launches()
    gk.launches = fk.launches = 0
    with Timers() as tm:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        coeffs = model.run_bem()
        wall_s = time.perf_counter() - t0
    launches = dict(bg.launches)
    rep = {k: v["total_s"] for k, v in tm.report().items()}
    info = coeffs.solver_info
    nf = len(coeffs.w)
    blocks = 2 * info["npanels_solved"] // 512
    expected = {"tile_inv": blocks * nf, "mm": blocks * nf,
                "mm_sub": blocks * nf}
    if info != {"npanels": 2470, "npanels_solved": 2560} or blocks != 10:
        raise AssertionError(f"unexpected BEM mesh {info}")
    if launches != expected or gk.launches or fk.launches:
        raise AssertionError(f"BEM launches {launches} != {expected} for "
                             f"{nf} solved frequencies")
    for k in ("A", "B", "X"):
        if not np.isfinite(getattr(coeffs, k)).all():
            raise AssertionError(f"non-finite BEM {k}")
    # the elimination of one frequency from the kernel phases' times
    solve_ms = blocks * (ti["ms"] + mm["mm"]["ms"] + mm["mm_sub"]["ms"])

    i = nf // 2
    panels = mesh.mesh_platform([m for m in model.members if m.potMod],
                                dz_max=3.0, da_max=2.0)
    lids = mesh.lid_panels_from_mesh(panels)
    t1 = time.perf_counter()
    ref = tb.solve_bem(panels, [coeffs.w[i]],
                       betas=np.deg2rad(coeffs.headings), rho=model.rho_water,
                       g=model.g, depth=model.depth, lid_panels=lids,
                       backend="cuda", device="cpu")
    cpu_s = time.perf_counter() - t1
    gaps = {}
    for k, bar in (("A", 2e-4), ("B", 1e-3), ("X", 2e-4)):
        r = ref[k][0]
        gaps[k] = np.abs(getattr(coeffs, k)[i] - r).max() / np.abs(r).max()
        if not gaps[k] <= bar:
            raise AssertionError(f"BEM {k} at w={coeffs.w[i]:.4f}: card vs "
                                 f"CPU {gaps[k]:.3e} > {bar:g}")
    host_s = rep["bem_mesh"] + rep["bem_rankine"]
    print(f"phase bem solve: panels={info['npanels']} solved_as="
          f"{info["npanels_solved"]} rows={2 * info["npanels_solved"]} "
          f"pivot_blocks={blocks} "
          f"frequencies={nf} launches={launches} run_bem_s={wall_s:.3f} "
          f"host_s={host_s:.3f} (mesh {rep['bem_mesh']:.3f}, rankine "
          f"{rep['bem_rankine']:.3f}) device_s={rep['bem_device']:.3f} "
          f"(of which elimination ~{nf * solve_ms / 1e3:.3f} s: "
          f"{solve_ms:.3f} ms per frequency from the kernel phases) "
          f"cpu_check w={coeffs.w[i]:.4f} gap_A={gaps['A']:.2e} gap_B="
          f"{gaps['B']:.2e} gap_X={gaps['X']:.2e} cpu_check_s={cpu_s:.1f}",
          flush=True)
    cheb_forms_phase(tb, panels, lids, coeffs.w[i], model.g)
    return model, launches


def bem_main_path_phase(rt, gk, bg, Timers, model):
    """analyze_cases in float64 on the card with the BEM coefficients;
    the same coefficients on the CPU."""
    bg.reset_launches()
    gk.launches = 0
    with Timers() as tm:
        with tm.time("analyze_cases"):
            model.analyze_cases()
    times = {k: v["total_s"] for k, v in tm.report().items()}
    rep = model.solve_report
    trips = int(rep.iters.max())
    if not rep.converged.all() or rep.nonfinite.any():
        raise AssertionError(f"unhealthy BEM cases: {rep}")
    if gk.launches != trips + LADDER_SOLVES or any(bg.launches.values()):
        raise AssertionError(f"BEM main path launches gj={gk.launches} "
                             f"bem={bg.launches}")
    cpu = rt.Model(bem_design(rt), device="cpu")
    cpu.analyze_unloaded()
    cpu.bem_coeffs = model.bem_coeffs
    cpu.analyze_cases()
    xi_rel = np.abs(model.Xi - cpu.Xi).max() / np.abs(cpu.Xi).max()
    if not xi_rel <= 1e-8:
        raise AssertionError(f"BEM main path card vs CPU Xi rel {xi_rel}")
    out = model.calc_outputs()
    if not np.isfinite(out["response"]["pitch RAO"]).all():
        raise AssertionError("non-finite RAO")
    print(f"phase bem main f64: cases={model.Xi.shape[0]} nw={model.nw} "
          f"converged=all trips={trips} gj_launches={gk.launches} "
          f"xi_rel_vs_cpu={xi_rel:.3e} {split(times)}", flush=True)

# ------------------------------------------------- integration surface

OMDAO_FD_EPS = 2e-3
# raft_tpu's bars for the exact partials against central differences of
# compute() (tests/test_parametric.py::test_omdao_scale_partials)
OMDAO_FD_BARS = (("design_scale_ballast", 5e-3),
                 ("design_scale_line_length", 5e-3),
                 ("design_scale_col_diam", 5e-2))
# except the Max_Offset row: on the flagship the adjoint (the derivative
# of the exact fixed point) differs from the derivative of compute()
# (whose fixed point stops at a 1 % tolerance) by 0.6-1.8 % there, in
# raft_tpu as in the port (ROADMAP.md queue 3 item 19), so that row is
# held at the loosest of raft_tpu's bars
OMDAO_OFFSET_BAR = 5e-2
STAT_CHANNELS = ("surge", "sway", "heave", "roll", "pitch", "yaw", "AxRNA",
                 "Mbase", "Tmoor")


def component_design(design):
    """``design`` in the flat component's conventions (tests/test_omdao.py):
    member stations normalized to 0..1 and one drag / added-mass
    coefficient per member."""
    d = copy.deepcopy(design)
    for mem in d["platform"]["members"]:
        st = np.asarray(mem["stations"], float)
        mem["stations"] = ((st - st[0]) / (st[-1] - st[0])).tolist()
        mem["Cd"], mem["Ca"], mem["CdEnd"], mem["CaEnd"] = 0.8, 0.97, 0.6, 0.6
    return d


def omdao_component(omdao, design, **modeling):
    """The port's RAFT_OMDAO (the openmdao-less shim) set up for
    ``design`` and given its flat inputs — the options and inputs of
    tests/test_omdao.py, for any design of that shape."""
    s = design["settings"]
    members = design["platform"]["members"]
    moor = design["mooring"]
    nw = len(np.arange(s["min_freq"], s["max_freq"] + 0.5 * s["min_freq"],
                       s["min_freq"]))
    comp = omdao.RAFT_OMDAO()
    comp.options["modeling_options"] = dict(dict(
        nfreq=nw, n_cases=len(design["cases"]["data"]),
        xi_start=s["XiStart"], min_freq=s["min_freq"],
        max_freq=s["max_freq"], nIter=s["nIter"],
        potential_model_override=0, dls_max=5.0, aeroServoMod=0,
        save_designs=False, trim_ballast=0, heave_tol=1.0), **modeling)
    comp.options["turbine_options"] = dict(
        npts=len(design["turbine"]["tower"]["stations"]), PC_GS_n=2,
        n_span=4, n_aoa=6, n_Re=1, n_tab=1, n_pc=3, n_af=1,
        af_used_names=["af0"], shape="circ", scalar_diameters=False,
        scalar_thicknesses=False, scalar_coefficients=True)
    comp.options["member_options"] = dict(
        nmembers=len(members), npts=[len(m["stations"]) for m in members],
        npts_lfill=[np.atleast_1d(m["l_fill"]).size for m in members],
        npts_rho_fill=[np.atleast_1d(m["rho_fill"]).size for m in members],
        ncaps=[0] * len(members),
        nreps=[len(np.atleast_1d(m["heading"])) if "heading" in m else 0
               for m in members],
        shape=[m["shape"] for m in members],
        scalar_thicknesses=[False] * len(members),
        scalar_diameters=[m["shape"] == "rect" for m in members],
        scalar_coefficients=[True] * len(members), n_ballast_type=2)
    comp.options["mooring_options"] = dict(
        nlines=len(moor["lines"]), nline_types=len(moor["line_types"]),
        nconnections=len(moor["points"]))
    comp.options["analysis_options"] = {"general": {"folder_output": "."}}
    comp.setup()

    turb, site = design["turbine"], design["site"]
    tower = turb["tower"]
    for name, v in (("turbine_mRNA", turb["mRNA"]),
                    ("turbine_IxRNA", turb["IxRNA"]),
                    ("turbine_IrRNA", turb["IrRNA"]),
                    ("turbine_xCG_RNA", turb["xCG_RNA"]),
                    ("turbine_hHub", turb["hHub"]),
                    ("turbine_Fthrust", turb["Fthrust"]),
                    ("turbine_yaw_stiffness",
                     design["platform"].get("yaw_stiffness", 0.0)),
                    ("rho_air", site["rho_air"]),
                    ("rho_water", site["rho_water"]),
                    ("mu_air", site["mu_air"]),
                    ("shear_exp", site["shearExp"])):
        comp.set_val(name, v)
    for key in ("rA", "rB", "gamma", "stations", "d", "t", "Cd", "Ca",
                "CdEnd", "CaEnd", "rho_shell"):
        comp.set_val(f"turbine_tower_{key}", tower[key])
    for i, mem in enumerate(members):
        p = f"platform_member{i+1}_"
        if "heading" in mem:
            comp.set_val(p + "heading", mem["heading"])
        for key in ("rA", "rB", "gamma", "stations", "t", "Cd", "Ca",
                    "CdEnd", "CaEnd", "rho_shell"):
            comp.set_val(p + key, mem[key])
        comp.set_val(p + "d", mem["d"][0] if mem["shape"] == "rect"
                     else mem["d"])
        comp.set_val(p + "l_fill", np.atleast_1d(mem["l_fill"]))
        comp.set_val(p + "rho_fill", np.atleast_1d(mem["rho_fill"]))
    comp.set_val("mooring_water_depth", moor["water_depth"])
    for i, pt in enumerate(moor["points"]):
        for key in ("name", "type", "location"):
            comp.set_val(f"mooring_point{i+1}_{key}", pt[key])
    for i, ln in enumerate(moor["lines"]):
        for key in ("endA", "endB", "type", "length"):
            comp.set_val(f"mooring_line{i+1}_{key}", ln[key])
    for i, lt in enumerate(moor["line_types"]):
        for key in ("name", "diameter", "mass_density", "stiffness",
                    "breaking_load", "cost", "transverse_added_mass",
                    "tangential_added_mass", "transverse_drag",
                    "tangential_drag"):
            comp.set_val(f"mooring_line_type{i+1}_{key}", lt[key])
    comp.set_val("raft_dlcs", design["cases"]["data"])
    comp.set_val("raft_dlcs_keys", design["cases"]["keys"])
    return comp


def quiet(fn, *args):
    """``fn(*args)`` with its per-case prints kept out of the log."""
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args)


# a DOF that a head sea leaves at rest carries round-off only, so the
# rigid-body channels are held against their DOF group's largest
# (ROADMAP.md queue 3 item 6)
DOF_GROUPS = (("surge", "sway", "heave"), ("roll", "pitch", "yaw"))


def output_scale(ref, name):
    """The scale an output is held against: a rigid-body channel's
    statistic the largest of its DOF group's avg / std / max (its PSD the
    largest of the group's PSDs), another channel's statistic the
    largest of its channel's avg / std / max, any other output its own
    largest magnitude."""
    group = [name]
    if name.startswith("stats_"):
        ch, stat = name[len("stats_"):].rsplit("_", 1)
        chans = next((g for g in DOF_GROUPS if ch in g), (ch,))
        stats = ("avg", "std", "max") if stat in ("avg", "std", "max") \
            else (stat,)
        group = [f"stats_{c}_{t}" for c in chans for t in stats
                 if f"stats_{c}_{t}" in ref]
    return max(float(np.abs(np.asarray(ref[g], float)).max())
               for g in group) or 1.0


def stats_gap(outputs, ref):
    """Worst gap of the component's outputs to ``ref`` (a mapping of
    the same names), each over its :func:`output_scale`."""
    worst, where = 0.0, None
    for name, b in ref.items():
        a = np.asarray(outputs[name], float)
        gap = float(np.abs(a - np.asarray(b, float)).max()) \
            / output_scale(ref, name)
        if gap > worst:
            worst, where = gap, name
    return worst, where


def compared_outputs(outputs):
    """The outputs held across devices: stats, aggregates, properties
    and the solver's health (its residual is a round-off value and is
    left out)."""
    return {k: np.array(v, float) for k, v in outputs.items()
            if k.startswith(("stats_", "properties_", "platform_"))
            or k in ("Max_Offset", "heave_avg", "Max_PtfmPitch",
                     "Std_PtfmPitch", "max_nacelle_Ax", "max_tower_base",
                     "solver_converged", "solver_iters", "solver_nonfinite",
                     "solver_recovery_tier")}


def direct_outputs(model):
    """What the component reports, from the port's direct Model."""
    cm = model.results["case_metrics"]
    out = {}
    for ch in STAT_CHANNELS:
        for s in ("avg", "std", "max"):
            out[f"stats_{ch}_{s}"] = cm[f"{ch}_{s}"]
    out["Max_Offset"] = np.sqrt(cm["surge_max"] ** 2
                                + cm["sway_max"] ** 2).max()
    out["heave_avg"] = cm["heave_avg"].mean()
    out["Max_PtfmPitch"] = cm["pitch_max"].max()
    out["Std_PtfmPitch"] = cm["pitch_std"].mean()
    out["max_nacelle_Ax"] = cm["AxRNA_std"].max()
    out["max_tower_base"] = cm["Mbase_max"].max()
    out["platform_displacement"] = model.statics.V
    return out


def omdao_phase(rt, card, gk):
    """Phase 22: RAFT_OMDAO on the card."""
    from raft_tpu_torch import omdao

    design = component_design(flagship(rt))
    comp = omdao_component(omdao, design, derivatives=True)
    quiet(comp.run)                                  # cold
    gk.launches = gk.launches_backward = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    quiet(comp.run)
    compute_s = time.perf_counter() - t0
    l_compute = gk.launches
    out = compared_outputs(comp._outputs)
    if out["solver_converged"].min() != 1.0 or out["solver_nonfinite"].any():
        raise AssertionError("RAFT_OMDAO on the card: unhealthy cases")

    direct = rt.Model(design)
    direct.analyze_unloaded()
    quiet(direct.analyze_cases)
    gap_direct, at_direct = stats_gap(out, direct_outputs(direct))
    cpu = omdao_component(omdao, design, derivatives=True, device="cpu")
    quiet(cpu.run)
    gap_cpu, at_cpu = stats_gap(out, compared_outputs(cpu._outputs))
    if not (gap_direct <= 1e-10 and gap_cpu <= 1e-10):
        raise AssertionError(
            f"RAFT_OMDAO on the card vs the direct Model {gap_direct:.3e} "
            f"({at_direct}), vs the CPU component {gap_cpu:.3e} ({at_cpu})")

    cold = {}
    t0 = time.perf_counter()
    quiet(comp.compute_partials, comp._inputs, cold)
    partials_cold_s = time.perf_counter() - t0
    gk.launches = gk.launches_backward = 0
    partials = {}
    t0 = time.perf_counter()
    quiet(comp.compute_partials, comp._inputs, partials)
    partials_s = time.perf_counter() - t0
    l_partials = dict(forward=gk.launches, backward=gk.launches_backward)
    worst_cold = max(abs(float(partials[k]) - float(v)) / abs(float(v))
                     for k, v in cold.items())
    if not worst_cold <= 1e-12:
        raise AssertionError(f"warm vs cold partials {worst_cold:.3e}")
    cpu_partials = {}
    quiet(cpu.compute_partials, cpu._inputs, cpu_partials)
    worst_cpu = max(abs(float(partials[k]) - float(v)) / abs(float(v))
                    for k, v in cpu_partials.items())
    if not worst_cpu <= 1e-8:
        raise AssertionError(f"card vs CPU partials {worst_cpu:.3e}")

    # central differences of compute() on the card
    base = {k: float(comp.get_val(k)) for k in omdao._PARTIAL_OUTPUTS}
    worst_fd = 0.0

    def values_at(name, s):
        comp.set_val(name, s)
        quiet(comp.run)
        comp.set_val(name, 1.0)
        return {k: float(comp.get_val(k)) for k in base}

    worst_row = dict.fromkeys(base, 0.0)
    for n, bar_n in OMDAO_FD_BARS:
        vp, vm = values_at(n, 1 + OMDAO_FD_EPS), values_at(n, 1 - OMDAO_FD_EPS)
        for k in base:
            bar = OMDAO_OFFSET_BAR if k == "Max_Offset" else bar_n
            fd = (vp[k] - vm[k]) / (2 * OMDAO_FD_EPS)
            scale = max(abs(fd), 1e-6 * max(abs(base[k]), 1.0))
            rel = abs(float(partials[k, n]) - fd) / scale
            worst_fd = max(worst_fd, rel / bar)
            worst_row[k] = max(worst_row[k], rel)
            if rel > bar:
                raise AssertionError(f"RAFT_OMDAO partial {k} / {n}: "
                                     f"{float(partials[k, n])} vs central "
                                     f"difference {fd} (rel {rel:.3e})")
    quiet(comp.run)

    # the loop an optimizer runs, warm, on the card host's CPU
    t0 = time.perf_counter()
    quiet(cpu.run)
    cpu_compute_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    quiet(cpu.compute_partials, cpu._inputs, {})
    cpu_partials_s = time.perf_counter() - t0
    print(f"phase omdao: {card} flagship as a component ("
          f"{direct.nw} w x {direct.Xi.shape[0]} cases) compute_s="
          f"{compute_s:.4f} gj_launches={l_compute} "
          f"stats_gap_vs_direct_model={gap_direct:.3e} stats_gap_vs_cpu="
          f"{gap_cpu:.3e} compute_partials cold_s={partials_cold_s:.3f} "
          f"warm_s={partials_s:.3f} gj_launches forward="
          f"{l_partials['forward']} backward={l_partials['backward']} "
          f"partials_rel_vs_cpu={worst_cpu:.3e} worst_vs_central_"
          f"differences={worst_fd:.3f} of the bar (per row "
          f"{ {k: f'{v:.2e}' for k, v in worst_row.items()} }) | iteration "
          f"(compute + compute_partials) card_s={compute_s + partials_s:.3f}"
          f" host_cpu_s={cpu_compute_s + cpu_partials_s:.3f} (compute "
          f"{cpu_compute_s:.3f}, partials {cpu_partials_s:.3f})",
          flush=True)
    return dict(gj_solve=l_compute, gj_solve_backward=l_partials["backward"])


def omdao_bem_phase(rt, bg, gk, bem_model):
    """Phase 22, BEM: one RAFT_OMDAO compute() with run_native_BEM on the
    potential-flow flagship on the card; its coefficients against phase
    13's within that phase's bars, its stats against the direct Model of
    the same design with those coefficients (1e-10)."""
    from raft_tpu_torch import omdao

    design = component_design(bem_design(rt))
    comp = omdao_component(omdao, design, potential_model_override=2,
                           run_native_BEM=True)
    bg.reset_launches()
    gk.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    quiet(comp.run)
    wall_s = time.perf_counter() - t0
    launches, gj_launches = dict(bg.launches), gk.launches
    coeffs, ref = comp._last_model.bem_coeffs, bem_model.bem_coeffs
    nf = len(coeffs.w)
    blocks = 2 * coeffs.solver_info["npanels_solved"] // 512
    if launches != {k: blocks * nf for k in launches}:
        raise AssertionError(f"OMDAO BEM launches {launches}")
    gaps = {}
    for k, bar in (("A", 2e-4), ("B", 1e-3), ("X", 2e-4)):
        r = getattr(ref, k)
        gaps[k] = float(np.abs(getattr(coeffs, k) - r).max()
                        / np.abs(r).max())
        if not gaps[k] <= bar:
            raise AssertionError(f"OMDAO BEM {k} vs phase 13 {gaps[k]:.3e}")
    direct = rt.Model(design)
    direct.analyze_unloaded()
    direct.bem_coeffs = coeffs
    quiet(direct.analyze_cases)
    gap, at = stats_gap(compared_outputs(comp._outputs),
                        direct_outputs(direct))
    if not gap <= 1e-10:
        raise AssertionError(f"OMDAO BEM stats vs the direct Model {gap:.3e}"
                             f" ({at})")
    print(f"phase omdao bem: run_native_BEM compute_s={wall_s:.3f} "
          f"launches={launches} gj_launches={gj_launches} gaps_vs_phase_13="
          f"{ {k: f'{v:.2e}' for k, v in gaps.items()} } stats_gap_vs_"
          f"direct_model={gap:.3e}", flush=True)
    return launches


def _plain(obj):
    """A design with NumPy scalars and arrays as plain Python values."""
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return _plain(obj.tolist())
    return obj.item() if isinstance(obj, np.generic) else obj


def fn_line(text):
    lines = [ln for ln in text.splitlines() if ln.startswith("Fn (Hz)")]
    if len(lines) != 1:
        raise AssertionError(f"no single natural-frequency line: {lines}")
    return lines[0]


def cli_phase(rt, gk):
    """Phase 23: ``python -m raft_tpu_torch <flagship.yaml> --plot`` in a
    subprocess in a temporary directory, then ``__main__.main`` in this
    process with the gj_solve launches counted, then the serve network
    tier refused."""
    import importlib.util
    import os
    import tempfile

    import yaml

    from raft_tpu_torch import __main__ as cli

    plots = importlib.util.find_spec("matplotlib") is not None
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "flagship.yaml")
        with open(path, "w") as fh:
            yaml.safe_dump(_plain(flagship(rt)), fh)
        env = dict(os.environ, PYTHONPATH=root, MPLBACKEND="Agg")
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "raft_tpu_torch", path, "--plot"],
            capture_output=True, text=True, timeout=300, env=env, cwd=tmp)
        cli_s = time.perf_counter() - t0
        for text in ("Natural frequencies", "analyzing cases"):
            if text not in out.stdout:
                raise AssertionError(f"CLI printed no '{text}':\n"
                                     f"{out.stdout[-2000:]}\n"
                                     f"{out.stderr[-2000:]}")
        pngs = {}
        if plots:
            if out.returncode != 0:
                raise AssertionError(f"CLI exit {out.returncode}:\n"
                                     f"{out.stderr[-2000:]}")
            for name in ("raft_tpu_geometry.png", "raft_tpu_responses.png"):
                pngs[name] = os.path.getsize(os.path.join(tmp, name))
                if not pngs[name] > 0:
                    raise AssertionError(f"empty {name}")
            plotted = f"pngs={pngs}"
        else:
            # matplotlib is not installed here: the figures cannot be
            # drawn, and the command must say so and fail
            if out.returncode == 0 or \
                    "No module named 'matplotlib'" not in out.stderr:
                raise AssertionError(
                    f"CLI --plot without matplotlib: exit {out.returncode}"
                    f"\n{out.stderr[-2000:]}")
            plotted = ("pngs=not drawn (matplotlib is not installed on this "
                       "machine; --plot exits 1 naming it, after the "
                       "analysis)")

        gk.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as log:
            cli.main([path])
        main_s = time.perf_counter() - t0
        launches = gk.launches
    if launches <= 0:
        raise AssertionError("the CLI launched no gj_solve")
    if fn_line(log.getvalue()) != fn_line(out.stdout):
        raise AssertionError("the CLI's natural frequencies differ in and "
                             "out of process")
    try:
        cli.main(["serve", "--http", "0"])
    except NotImplementedError as e:
        if "queue 1 step 12b" not in str(e):
            raise
    else:
        raise AssertionError("'serve --http' did not raise")
    print(f"phase cli: subprocess exit={out.returncode} wall_s={cli_s:.2f} "
          f"{plotted} | in process main_s={main_s:.3f} gj_launches="
          f"{launches} '{fn_line(out.stdout)}' | serve --http raises "
          f"naming step 12b", flush=True)
    return dict(gj_solve=launches)


def checked_phase(rt, gk):
    """Phase 24: validate.checked_pipeline on the flagship on the card."""
    from raft_tpu_torch import validate
    from raft_tpu_torch.convert import case_args_from_numpy

    model = rt.Model(flagship(rt))
    model.analyze_unloaded()
    quiet(model.analyze_cases)
    args, _ = model.prepare_case_inputs(verbose=False)
    run = validate.checked_pipeline(model)
    unchecked = model.case_pipeline_fn()
    targs = case_args_from_numpy(args, model.device, model.dtype)
    run(*args)                                       # warm
    gk.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    xr, xi, rep = run(*args)
    torch.cuda.synchronize()
    checked_s = time.perf_counter() - t0
    launches = gk.launches
    t0 = time.perf_counter()
    ur, ui, urep = unchecked(*targs)
    torch.cuda.synchronize()
    unchecked_s = time.perf_counter() - t0
    Xi = (xr.to("cpu", torch.float64).numpy()
          + 1j * xi.to("cpu", torch.float64).numpy())
    if not (torch.equal(xr, ur) and torch.equal(xi, ui)
            and all(torch.equal(a, b) for a, b in zip(rep, urep))
            and np.array_equal(Xi, model.Xi)):
        raise AssertionError("checked pipeline not bit-identical to legacy")
    raised = {}
    for index, name in ((2, "C_lin"), (5, "F_add_r")):
        bad = list(args)
        bad[index] = np.full_like(bad[index], np.nan)
        try:
            run(*bad)
        except FloatingPointError as e:
            if "nan" not in str(e):
                raise
            raised[name] = str(e)
        else:
            raise AssertionError(f"poisoned {name} did not raise")
    for name, phase in (("C_lin", "assembled Z and F"),
                        ("F_add_r", "excitation")):
        if phase not in raised[name]:
            raise AssertionError(f"poisoned {name}: {raised[name]}")
    print(f"phase checked pipeline: bit_identical_to_legacy=True "
          f"gj_launches={launches} checked_s={checked_s:.4f} unchecked_s="
          f"{unchecked_s:.4f} poisoned C_lin -> '{raised['C_lin']}', "
          f"F_add_r -> '{raised['F_add_r']}'", flush=True)
    return dict(gj_solve=launches)



# ----------------------------------------------------------- serve phases

SERVE_FILLS = np.linspace(1000.0, 1210.0, 8)     # outer-column fill density
SERVE_DRAFTS = np.linspace(0.9, 1.1, 64)
SERVE_SWEEP_CHUNK = 8
SERVE_CLIENTS = 4
SERVE_BAR = 1e-12                    # served vs the un-bucketed Model
FUSED_BAR = (1e-8, 1e-12)            # rtol, atol of max|Xi| (phase 8's)
GRAD_BAR = 1e-8


def _ballast_variant(rt, rho):
    d = flagship(rt)
    for mem in d["platform"]["members"]:
        if mem["name"] == "outer":
            mem["rho_fill"] = float(rho)
    return d


def serve_requests(rt):
    """The serve phases' ten requests: eight flagship ballast variants
    and two aero semis (12 cases each)."""
    out = [_ballast_variant(rt, r) for r in SERVE_FILLS]
    aero = aero_design(rt)
    out.append(aero)
    aero2 = aero_design(rt)
    for mem in aero2["platform"]["members"]:
        if mem["name"] == "outer":
            mem["rho_fill"] = 1100.0
    out.append(aero2)
    return out


def _engine(rt, tmp, **kw):
    cfg = dict(device=CARD, precision="float64", window_ms=5.0,
               cache_dir=tmp, use_result_cache=False)
    cfg.update(kw)
    return rt.serve.Engine(rt.serve.EngineConfig(**cfg))


def _submit_from_clients(eng, designs, n_clients=SERVE_CLIENTS):
    """Every design submitted from ``n_clients`` threads at once; the
    handles in design order."""
    import threading

    handles = [None] * len(designs)
    errors = []

    def client(k):
        try:
            for i in range(k, len(designs), n_clients):
                handles[i] = eng.submit(designs[i])
        except Exception as e:  # noqa: BLE001 — raised below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(k,))
               for k in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    if errors:
        raise errors[0]
    return handles


def _xi(res):
    return torch.as_tensor(res.Xi)


def serve_coalesce_phase(rt, gk, fk, tmp, fixed_point="legacy",
                         legacy=None):
    """The coalesce phase (legacy) and the fused phase: the ten requests
    from four client threads through one engine, then each request alone
    in a fresh engine and through ``Model(design, slots=bucket)``."""
    import raft_tpu_torch.dynamics as dyn
    import raft_tpu_torch.waterfall as wfm

    designs = serve_requests(rt)
    mode = fixed_point
    with _engine(rt, tmp, fixed_point=mode) as eng:
        # programs + prep warm; the flagship's bucket
        spec = eng.evaluate(designs[0], timeout=600).bucket
        # the served kernel's operands: gj_solve at the bucket's
        # n_slots x nw systems, fused_block's first block in the bucket
        if mode == "fused":
            cap = _Capture(wfm.fused_block, None, arg=1,
                           nodes=spec.n_nodes)
            wfm.fused_block = cap
        else:
            cap = _Capture(dyn.gj_solve, spec.n_slots * spec.nw)
            dyn.gj_solve = cap
        gk.launches = 0
        fk.launches = 0
        t0 = time.perf_counter()
        try:
            res = [h.result(600) for h in _submit_from_clients(eng,
                                                                designs)]
        finally:
            if mode == "fused":
                wfm.fused_block = cap.fn
            else:
                dyn.gj_solve = cap.fn
        wall = time.perf_counter() - t0
        launches = dict(gj_solve=gk.launches, fused_block=fk.launches)
        snap = eng.snapshot()
    kernel = "fused_block" if mode == "fused" else "gj_solve"
    (_, err), = _hold_captured(
        gk, fk, f"in the served {mode} dispatch",
        **({"cap_fb": cap} if mode == "fused" else {"cap_gj": cap})
    ).values()
    a = cap.args
    shapes = (f"nodes.r {tuple(a[0].r.shape)} u {tuple(a[1].shape)}"
              if mode == "fused" else f"M {tuple(a[0].shape)}")
    held = (f"{kernel} on the served operands ({shapes}) vs its plain "
            f"version max_abs_err={err:.3e}")
    if not all(r.ok for r in res):
        raise AssertionError([(r.status, r.error) for r in res])
    dispatches = snap["dispatches"] - 1
    if not dispatches < len(designs):
        raise AssertionError(f"{dispatches} dispatches for "
                             f"{len(designs)} requests")
    if {r.backend for r in res} != {"cuda"}:
        raise AssertionError("a request served off the card")
    with _engine(rt, tmp, fixed_point=mode, window_ms=0.5) as eng:
        solo = [eng.evaluate(d, timeout=600) for d in designs]
    worst = 0.0
    for d, r, s in zip(designs, res, solo):
        if not torch.equal(_xi(r), _xi(s)):
            raise AssertionError(f"{mode}: served coalesced != served "
                                 f"alone (rid {r.rid})")
        m = rt.Model(d, device=CARD, slots=r.bucket)
        m.analyze_unloaded()
        quiet(m.analyze_cases, 0, False, None, None, mode)
        if not torch.equal(torch.as_tensor(m.Xi), _xi(r)):
            raise AssertionError(f"{mode}: served != Model(slots=bucket)")
        if mode == "legacy":
            m.slots = None
            quiet(m.analyze_cases)
            gap = float(np.abs(m.Xi - r.Xi).max() / np.abs(m.Xi).max())
            worst = max(worst, gap)
            if gap > SERVE_BAR:
                raise AssertionError(f"served vs un-bucketed {gap:.3g}")
    if legacy is not None:
        for r, ref in zip(res, legacy):
            if not np.array_equal(r.solve_report["converged"],
                                  ref.solve_report["converged"]):
                raise AssertionError("fused flags differ from legacy")
            scale = np.abs(ref.Xi).max()
            np.testing.assert_allclose(
                r.Xi, ref.Xi, rtol=FUSED_BAR[0], atol=FUSED_BAR[1] * scale)
            worst = max(worst, float(np.abs(r.Xi - ref.Xi).max() / scale))
    buckets = sorted({(r.bucket.nw, r.bucket.n_nodes, r.bucket.n_slots)
                      for r in res})
    lat = np.array([r.latency_s for r in res])
    queued = np.array([r.queue_s for r in res])
    occupancy = float(np.mean([r.batch_occupancy for r in res]))
    per = {k: v / dispatches for k, v in launches.items()}
    if launches[kernel] <= 0:
        raise AssertionError(f"{kernel} not launched in the {mode} serve")
    print(f"phase serve {'coalesce' if mode == 'legacy' else 'fused'}: "
          f"requests={len(designs)} clients={SERVE_CLIENTS} window_ms=5 "
          f"dispatches={dispatches} buckets={buckets} occupancy_mean="
          f"{occupancy:.3f} launches="
          f"{launches} per_dispatch={per} wall_s={wall:.3f} latency "
          f"p50={np.percentile(lat, 50):.4f} p95="
          f"{np.percentile(lat, 95):.4f} (of which queued, the cold "
          f"preps: p50={np.percentile(queued, 50):.4f}) | coalesced == "
          f"alone == "
          f"Model(slots): torch.equal "
          + (f"| vs un-bucketed Model max_rel={worst:.3g} (bar "
             f"{SERVE_BAR:g})" if mode == "legacy" else
             f"| vs legacy served max_rel={worst:.3g} flags identical")
          + f" backend=cuda | {held}", flush=True)
    return res, dict(launches, dispatches=dispatches)


def _probe_loop(eng, design, stop, out):
    while not stop.is_set():
        out.append(eng.evaluate(design, timeout=600))


def serve_sweep_phase(rt, gk, tmp):
    """64 draft-scaled aero semis as one served sweep, uninterrupted and
    under interactive load with preemption on and off."""
    import threading

    from raft_tpu_torch.sweep_fused import scale_draft

    designs = [scale_draft(aero_design(rt), float(s)) for s in SERVE_DRAFTS]
    probe = _ballast_variant(rt, 1050.0)
    runs = {}
    with _engine(rt, tmp, fixed_point="waterfall", preempt=True) as eng:
        warm = eng.evaluate(probe, timeout=600)
        t0 = time.perf_counter()
        ref = eng.submit_sweep(designs, chunk=SERVE_SWEEP_CHUNK).result(1200)
        runs["uninterrupted"] = (ref, time.perf_counter() - t0, [])
        for name, preempt in (("on", True), ("off", False)):
            eng.config.preempt = preempt
            stop, probes = threading.Event(), []
            h = eng.submit_sweep(designs, chunk=SERVE_SWEEP_CHUNK)
            t = threading.Thread(target=_probe_loop,
                                 args=(eng, probe, stop, probes))
            t0 = time.perf_counter()
            t.start()
            res = h.result(1200)
            stop.set()
            t.join(600)
            runs[name] = (res, time.perf_counter() - t0, probes)
        snap = eng.snapshot()
    for name, (res, _, probes) in runs.items():
        if res.status != "ok":
            raise AssertionError(f"sweep {name}: {res.status} {res.error}")
        if not (torch.equal(torch.as_tensor(res.Xi_r),
                            torch.as_tensor(ref.Xi_r))
                and torch.equal(torch.as_tensor(res.Xi_i),
                                torch.as_tensor(ref.Xi_i))):
            raise AssertionError(f"sweep {name} != uninterrupted")
        for p in probes:
            if not torch.equal(_xi(p), _xi(warm)):
                raise AssertionError("an interactive probe changed bits")
    if runs["on"][0].preemptions < 1:
        raise AssertionError("the loaded sweep never yielded")
    p95 = {k: (float(np.percentile([p.latency_s for p in v[2]], 95))
               if v[2] else float("nan")) for k, v in runs.items()}
    loaded = " | ".join(
        f"preempt_{k}: sweep_s={runs[k][1]:.3f} yields="
        f"{runs[k][0].preemptions} suspend_s={runs[k][0].suspend_s:.3f} "
        f"probes={len(runs[k][2])} interactive_p50_s="
        f"{float(np.percentile([p.latency_s for p in runs[k][2]], 50)):.4f}"
        f" p95_s={p95[k]:.4f}" for k in ("on", "off"))
    print(f"phase serve sweep: designs={len(designs)} chunks="
          f"{ref.n_chunks} (chunk {SERVE_SWEEP_CHUNK} x 12 cases) "
          f"uninterrupted_s={runs['uninterrupted'][1]:.3f} (its preps "
          f"included) | {loaded} | resumed == uninterrupted: "
          f"torch.equal converged={int(ref.report['converged'].sum())}/"
          f"{ref.report['converged'].size} sweep_preemptions="
          f"{snap['sweep_preemptions']}", flush=True)


def serve_faults_phase(rt, tmp, ref):
    """Chaos faults on the card, each to its terminal status, batch-mates'
    bits unchanged; a result-cache hit without a dispatch."""
    import os

    a, b = _ballast_variant(rt, SERVE_FILLS[0]), \
        _ballast_variant(rt, SERVE_FILLS[1])
    seen = {}
    with _engine(rt, tmp, window_ms=50.0, chaos="nan_lane@3:5") as eng:
        eng.evaluate(a, timeout=600)                 # rid 1
        eng.evaluate(b, timeout=600)                 # rid 2
        ra, rb = [h.result(600) for h in (eng.submit(a), eng.submit(b))]
    if not (ra.ok and ra.solve_report["nonfinite"].all()
            and rb.ok and not rb.solve_report["nonfinite"].any()
            and torch.equal(_xi(rb), _xi(ref[1]))
            and ra.batch_requests == 2):
        raise AssertionError("nan_lane: quarantine or batch-mate bits")
    seen["nan_lane"] = "ok, own lanes nonfinite, mate bit-identical"
    with _engine(rt, tmp, chaos="backend_error*1:3") as eng:
        r = eng.evaluate(a, timeout=600)
        snap = eng.snapshot()
    if not (r.ok and snap["dispatch_retries"] == 1
            and torch.equal(_xi(r), _xi(ref[0]))):
        raise AssertionError("backend_error: not retried to the same bits")
    seen["backend_error"] = "retried -> ok, bit-identical"
    with _engine(rt, tmp, watchdog_s=1.0, breaker_cooldown_s=2.0,
                 dispatch_retries=0,
                 chaos="dispatch_stall=3.0*1:9") as eng:
        t0 = time.perf_counter()
        r1 = eng.evaluate(a, timeout=600)        # the stalled dispatch
        stall_s = time.perf_counter() - t0
        r2 = eng.evaluate(a, timeout=600)
        time.sleep(2.5)                          # the breaker's cooldown
        r3 = eng.evaluate(a, timeout=600)
        snap = eng.snapshot()
    statuses = [r1.status, r2.status, r3.status]
    if statuses != ["watchdog_timeout", "rejected_circuit", "ok"] \
            or not torch.equal(_xi(r3), _xi(ref[0])):
        raise AssertionError(f"watchdog/breaker cycle: {statuses}")
    seen["dispatch_stall"] = f"watchdog_timeout after {stall_s:.2f} s"
    seen["breaker"] = "rejected_circuit, then half-open probe ok"
    cache = os.path.join(tmp, "results")
    with _engine(rt, cache, use_result_cache=True) as eng:
        r1 = eng.evaluate(a, timeout=600)
        for _ in range(500):
            if eng.snapshot()["result_cache_stores"]:
                break
            time.sleep(0.01)
        t0 = time.perf_counter()
        r2 = eng.evaluate(a, timeout=600)
        hit_s = time.perf_counter() - t0
        snap = eng.snapshot()
    if not (snap["result_cache_hits"] == 1 and snap["dispatches"] == 1
            and torch.equal(_xi(r1), _xi(r2))):
        raise AssertionError("result cache: no bit-identical hit")
    if {x.backend for x in (ra, rb, r, r3, r1, r2)} != {"cuda"}:
        raise AssertionError("a request served off the card")
    print(f"phase serve faults: {seen} | result cache hit: same bits, "
          f"dispatches=1 hit_s={hit_s:.4f} cold_s={r1.latency_s:.4f} | "
          f"every ok result backend=cuda", flush=True)


def _serve_process(root, cache, lines):
    import json
    import os

    env = dict(os.environ, PYTHONPATH=root)
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "raft_tpu_torch", "serve", "--cache-dir",
         cache, "--device", CARD],
        input="".join(json.dumps({"design": d}) + "\n" for d in lines),
        capture_output=True, text=True, timeout=600, env=env, cwd=root)
    wall = time.perf_counter() - t0
    if out.returncode != 0:
        raise AssertionError(f"serve exit {out.returncode}:\n"
                             f"{out.stderr[-3000:]}")
    docs = [json.loads(ln) for ln in out.stdout.splitlines()
            if ln.startswith("{")]
    events = [d["event"] for d in docs]
    if events != ["ready", "result", "result", "shutdown"] or not all(
            d["status"] == "ok" for d in docs[1:3]):
        raise AssertionError(f"serve lines: {out.stdout[-3000:]}")
    return docs, wall


def serve_restart_phase(rt, tmp):
    """A fresh ``python -m raft_tpu_torch serve`` process (stdin design
    lines) on an empty cache directory, then a fresh one on the same
    directory with the same designs (manifest replayed, prep and result
    caches warm) and one with two unseen ballast variants (the manifest
    alone)."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    cache = os.path.join(tmp, "restart")
    seen = [_plain(_ballast_variant(rt, r)) for r in (1000.0, 1030.0)]
    unseen = [_plain(_ballast_variant(rt, r)) for r in (1015.0, 1045.0)]
    cold, cold_s = _serve_process(root, cache, seen)
    warm, warm_s = _serve_process(root, cache, seen)
    fresh, fresh_s = _serve_process(root, cache, unseen)
    for a, b in zip(cold[1:3], warm[1:3]):
        if a["std"] != b["std"]:
            raise AssertionError("warm restart changed the answer")
    rep = {name: d[0].get("warmup", {}) for name, d in
           (("cold", cold), ("warm", warm), ("unseen", fresh))}
    if rep["warm"].get("nvcc_builds") != 0 \
            or rep["warm"].get("n_warmed", 0) < 1:
        raise AssertionError(f"warm restart: {rep['warm']}")
    first = {name: f"{d[1]['latency_s']:.4f} (queue {d[1]['queue_s']:.4f})"
             for name, d in (("cold", cold), ("warm", warm),
                             ("unseen", fresh))}
    print(f"phase serve warm restart: replayed buckets cold="
          f"{rep['cold'].get('n_warmed')} warm={rep['warm']['n_warmed']} "
          f"unseen={rep['unseen'].get('n_warmed')} | nvcc_builds warm="
          f"{rep['warm']['nvcc_builds']} libraries_loaded warm="
          f"{rep['warm'].get('libraries_loaded')} programs_built warm="
          f"{rep['warm'].get('programs_built')} warmup_s warm="
          f"{rep['warm'].get('wall_s')} | first-request latency cold="
          f"{first['cold']} warm={first['warm']} (result cache hits "
          f"{warm[-1]['result_cache_hits']}, prep cache hits "
          f"{warm[-1]['prep_cache_hits']}) unseen={first['unseen']} "
          f"(manifest only) | process wall_s cold={cold_s:.1f} warm="
          f"{warm_s:.1f} unseen={fresh_s:.1f} | same std bits", flush=True)


def serve_grad_phase(rt, gk, tmp):
    """``Engine.submit_grad`` on the flagship against
    ``grad.design_value_and_grad`` on the card."""
    from raft_tpu_torch.grad import design_value_and_grad

    design = flagship(rt)
    obj = {"metric": "rao_pitch_peak", "knobs": ["draft", "ballast",
                                                 "col_diam",
                                                 "line_length"]}
    with _engine(rt, tmp) as eng:
        gk.launches = 0
        gk.launches_backward = 0
        t0 = time.perf_counter()
        r = eng.evaluate_grad(design, obj, timeout=900)
        served_s = time.perf_counter() - t0
        launches = (gk.launches, gk.launches_backward)
    if not r.ok:
        raise AssertionError(f"served grad {r.status}: {r.error}")
    t0 = time.perf_counter()
    value, grad = design_value_and_grad(design, "rao_pitch_peak",
                                        device=CARD)
    direct_s = time.perf_counter() - t0
    gap = abs(r.value - value) / abs(value)
    g_ref = np.array([grad[k] for k in obj["knobs"]])
    g = np.array([r.gradient[k] for k in obj["knobs"]])
    ggap = float(np.abs(g - g_ref).max() / np.abs(g_ref).max())
    if gap > GRAD_BAR or ggap > GRAD_BAR:
        raise AssertionError(f"served grad off: {gap:.3g} {ggap:.3g}")
    print(f"phase serve grad: flagship rao_pitch_peak value_rel={gap:.3g} "
          f"grad_rel={ggap:.3g} (bar {GRAD_BAR:g}) served_s={served_s:.2f} "
          f"direct_s={direct_s:.2f} gj_launches forward={launches[0]} "
          f"backward={launches[1]}", flush=True)
    return dict(gj_solve=launches[0], gj_solve_backward=launches[1])


def serve_phases(rt, gk, fk):
    """Phases 25-30: the serving engine on the card."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        legacy, l_co = serve_coalesce_phase(rt, gk, fk, tmp)
        _, l_fu = serve_coalesce_phase(rt, gk, fk, tmp, "fused", legacy)
        serve_sweep_phase(rt, gk, tmp)
        serve_faults_phase(rt, tmp, legacy)
        serve_restart_phase(rt, tmp)
        l_grad = serve_grad_phase(rt, gk, tmp)
    return dict(coalesce=l_co, fused=l_fu, grad=l_grad)


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this "
                 "script needs an NVIDIA card")
    # the yardsticks in full float32 (PyTorch's defaults, stated)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)

    import raft_tpu_torch as rt
    from raft_tpu_torch.kernels import bem_gj as bg
    from raft_tpu_torch.kernels import fused_block as fk
    from raft_tpu_torch.kernels import gj_solve as gk
    from raft_tpu_torch.utils.profiling import Timers

    build_phase((gk, fk, bg))
    g64 = gj_kernel_phase(gk, torch.float64)
    gj_kernel_phase(gk, torch.float32)

    prep = rt.Model(flagship(rt))
    prep.analyze_unloaded()
    args, _ = prep.prepare_case_inputs(verbose=False)
    f64 = fused_kernel_phase(fk, prep, args, torch.float64, 1e-12)
    fused_kernel_phase(fk, prep, args, torch.float32, 1e-5)

    legacy, l_leg = legacy_phases(rt, Timers)
    l_wf, l_fu = engine_phases(rt, Timers, legacy)
    megabatch_phase(rt, legacy, args)
    mixed_precision_phase(rt, Timers, legacy)
    l_aero = aero_phase(rt, Timers)
    l_bridled = bridled_phase(rt, Timers)
    ballast_phase(rt)
    l_sweep = headline_sweep_phase(rt, card)
    l_design = general_sweeps_phase(rt, card)
    bwd64 = gj_backward_phase(gk, torch.float64)
    gj_backward_phase(gk, torch.float32)
    l_grad = design_gradients_phase(rt, card)
    l_prep = batched_prep_phase(rt, card)

    ti32 = tile_inv_phase(bg, torch.float32, 1e-5)
    tile_inv_phase(bg, torch.float64, 1e-12)
    mm32 = {dt: mm_phase(bg, dt) for dt in (torch.float32, torch.float64)}
    bem_model, l_bem = bem_phase(rt, bg, gk, fk, Timers, ti32,
                                 mm32[torch.float32])
    bem_main_path_phase(rt, gk, bg, Timers, bem_model)

    l_omdao = omdao_phase(rt, card, gk)
    l_omdao_bem = omdao_bem_phase(rt, bg, gk, bem_model)
    l_cli = cli_phase(rt, gk)
    l_checked = checked_phase(rt, gk)
    l_serve = serve_phases(rt, gk, fk)
    new_paths = dict(serve=l_serve["coalesce"]["gj_solve"],
                     serve_fused=l_serve["fused"]["fused_block"],
                     serve_grad=l_serve["grad"]["gj_solve"],
                     omdao=l_omdao["gj_solve"],
                     backward_omdao=l_omdao["gj_solve_backward"],
                     cli=l_cli["gj_solve"], checked=l_checked["gj_solve"],
                     **{f"omdao_bem_{k}": v for k, v in l_omdao_bem.items()})
    if not all(v > 0 for v in new_paths.values()):
        raise AssertionError(f"a kernel was not launched on a new path: "
                             f"{new_paths}")

    kernels = [
        dict(name="gj_solve", route="cuda",
             source="raft_tpu_torch/csrc/gj_solve.cu",
             replaces="raft_tpu/pallas_kernels.py:150",
             launches=l_leg["gj_solve"],
             launches_waterfall=l_wf["gj_solve"],
             launches_fused=l_fu["gj_solve"],
             launches_aero=l_aero["legacy"]["gj_solve"],
             launches_bridled=l_bridled["legacy"]["gj_solve"],
             launches_sweep_waterfall=l_sweep["waterfall"]["gj_solve"],
             launches_sweep_fused=l_sweep["fused"]["gj_solve"],
             launches_design_sweep=l_design["gj_solve"],
             launches_grad=l_grad["flagship"]["gj_solve"],
             launches_backward_grad=l_grad["flagship"]["gj_solve_backward"],
             launches_backward_grad_aero=l_grad["aero"]["gj_solve_backward"],
             launches_backward_value_and_grad=l_grad[
                 "flagship_rao_pitch_peak"]["gj_solve_backward"],
             launches_batched_prep_sweep=l_prep["gj_solve"],
             launches_omdao=l_omdao["gj_solve"],
             launches_backward_omdao=l_omdao["gj_solve_backward"],
             launches_cli=l_cli["gj_solve"],
             launches_checked=l_checked["gj_solve"],
             launches_serve=l_serve["coalesce"]["gj_solve"],
             launches_serve_per_dispatch=l_serve["coalesce"]["gj_solve"]
             / l_serve["coalesce"]["dispatches"],
             launches_serve_fused=l_serve["fused"]["gj_solve"],
             launches_serve_grad=l_serve["grad"]["gj_solve"],
             launches_backward_serve_grad=l_serve["grad"][
                 "gj_solve_backward"], **g64, **bwd64),
        dict(name="fused_block", route="cuda",
             source="raft_tpu_torch/csrc/fused_block.cu",
             replaces="raft_tpu/pallas_kernels.py:428",
             launches=l_fu["fused_block"],
             launches_aero=l_aero["fused"]["fused_block"],
             launches_bridled=l_bridled["fused"]["fused_block"],
             launches_sweep_fused=l_sweep["fused"]["fused_block"],
             launches_serve_fused=l_serve["fused"]["fused_block"],
             launches_serve_fused_per_dispatch=l_serve["fused"][
                 "fused_block"] / l_serve["fused"]["dispatches"], **f64),
        dict(name="tile_inv", route="cuda",
             source="raft_tpu_torch/csrc/tile_inv.cu",
             replaces="raft_tpu/pallas_kernels.py:208",
             launches=l_bem["tile_inv"],
             launches_omdao_bem=l_omdao_bem["tile_inv"], **ti32),
        dict(name="mm", route="cuda", source="raft_tpu_torch/csrc/mm.cu",
             replaces="raft_tpu/pallas_kernels.py:253",
             launches=l_bem["mm"],
             launches_omdao_bem=l_omdao_bem["mm"],
             **mm32[torch.float32]["mm"]),
        dict(name="mm_sub", route="cuda", source="raft_tpu_torch/csrc/mm.cu",
             replaces="raft_tpu/pallas_kernels.py:263",
             launches=l_bem["mm_sub"],
             launches_omdao_bem=l_omdao_bem["mm_sub"],
             **mm32[torch.float32]["mm_sub"]),
    ]
    for k in kernels:
        if not all(math.isfinite(k[key]) for key in
                   ("max_abs_err", "ms", "plain_ms", "bound_ms")):
            raise AssertionError(f"non-finite kernel numbers: {k}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
