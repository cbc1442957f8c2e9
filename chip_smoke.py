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
    checkpoints, bit-identical.

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.  In the kernel table ``ms`` is the
time of one call from Python (as ``plain_ms`` and ``library_ms`` are
taken); ``device_ms``, where given, the kernel's device time alone.
Without CUDA, or without the raft_tpu_torch package beside it, the script
exits non-zero and prints no result.
"""

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
    call whose argument ``arg`` has ``lanes`` rows, and forwards every
    call."""

    def __init__(self, fn, lanes, arg=0):
        self.fn, self.lanes, self.arg = fn, lanes, arg
        self.args = self.kw = None

    def __call__(self, *args, **kw):
        if self.args is None and args[self.arg].shape[0] == self.lanes:
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
    checks = {}
    for name, cap in (("gj_solve", wf["cap_gj"]),
                      ("fused_block", fu["cap_fb"])):
        if cap.args is None:
            raise AssertionError(f"{name} never ran at the 1024 rung")
    out_k, piv_k = gk.gj_solve(*wf["cap_gj"].args)
    out_p, piv_p = gk.gj_solve_reference(*wf["cap_gj"].args)
    torch.cuda.synchronize()
    fin = ~torch.isnan(out_p)
    if not (torch.equal(torch.isnan(out_k), ~fin)
            and torch.equal(out_k[fin], out_p[fin])):
        raise AssertionError("gj_solve at the sweep rung differs from its "
                             "plain version")
    checks["gj_solve"] = (wf["cap_gj"].args[0].shape[0], 0.0)
    a, kw = fu["cap_fb"].args, fu["cap_fb"].kw
    out_k = fk.fused_block(*a, **kw)
    out_p = fk.fused_block_reference(*a, **kw)
    torch.cuda.synchronize()
    for k in (0, 4, 5):
        if not torch.equal(out_k[k], out_p[k]):
            raise AssertionError(f"fused_block at the sweep rung: output "
                                 f"{k} differs from its plain version")
    err = max((out_k[k] - out_p[k]).abs().max().item() for k in (1, 2, 3))
    x_max = max(out_p[k].abs().max().item() for k in (1, 2, 3))
    if not err <= 1e-12 * x_max:
        raise AssertionError(f"fused_block at the sweep rung: {err} > "
                             f"1e-12 * {x_max}")
    G = fk.launch_shape(a[1].shape[1], a[1].shape[-1], a[1].dtype)[0]
    checks["fused_block"] = (a[1].shape[0], err)
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

    ti32 = tile_inv_phase(bg, torch.float32, 1e-5)
    tile_inv_phase(bg, torch.float64, 1e-12)
    mm32 = {dt: mm_phase(bg, dt) for dt in (torch.float32, torch.float64)}
    bem_model, l_bem = bem_phase(rt, bg, gk, fk, Timers, ti32,
                                 mm32[torch.float32])
    bem_main_path_phase(rt, gk, bg, Timers, bem_model)

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
             launches_design_sweep=l_design["gj_solve"], **g64),
        dict(name="fused_block", route="cuda",
             source="raft_tpu_torch/csrc/fused_block.cu",
             replaces="raft_tpu/pallas_kernels.py:428",
             launches=l_fu["fused_block"],
             launches_aero=l_aero["fused"]["fused_block"],
             launches_bridled=l_bridled["fused"]["fused_block"],
             launches_sweep_fused=l_sweep["fused"]["fused_block"], **f64),
        dict(name="tile_inv", route="cuda",
             source="raft_tpu_torch/csrc/tile_inv.cu",
             replaces="raft_tpu/pallas_kernels.py:208",
             launches=l_bem["tile_inv"], **ti32),
        dict(name="mm", route="cuda", source="raft_tpu_torch/csrc/mm.cu",
             replaces="raft_tpu/pallas_kernels.py:253",
             launches=l_bem["mm"], **mm32[torch.float32]["mm"]),
        dict(name="mm_sub", route="cuda", source="raft_tpu_torch/csrc/mm.cu",
             replaces="raft_tpu/pallas_kernels.py:263",
             launches=l_bem["mm_sub"], **mm32[torch.float32]["mm_sub"]),
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
