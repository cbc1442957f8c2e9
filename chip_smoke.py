"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (each prints a line; any failure raises and exits non-zero):

1. the card's name and power limit, as nvidia-smi reports them;
2. build of the CUDA kernel from raft_tpu_torch/csrc/gj_solve.cu (nvcc,
   sm_90a), with the compiler's register report and the build seconds;
3. the kernel against its plain PyTorch version on the card at the main
   path's shape [1536, 12, 13], in float64 and float32, with zero-diagonal
   systems (row swaps) and one NaN system; kernel, plain and
   ``torch.linalg.solve`` (the yardstick; the port never calls it) times
   by CUDA events, and the kernel's bound;
4. the main path in float64: the flagship design (128 frequencies x 12
   JONSWAP cases) through ``Model(design)`` on the card —
   ``analyze_unloaded``, ``solve_eigen`` and ``analyze_cases`` twice; the
   second, warm call is timed and its kernel launches counted, and its
   response is held against the same port run on the CPU;
5. the main path in float32 on the card, RAO L-inf against the float64
   card run.

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.  Without CUDA, or without the
raft_tpu_torch package beside it, the script exits non-zero and prints no
result.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and the
# non-tensor-core FP64 / FP32 rates
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.float64: 34e12, torch.float32: 67e12}
# GJ solves of one recovery-ladder pass (raft_tpu_torch/dynamics.py):
# tier 0 solve + 1 refinement, tier 1's 2 refinements, the condition
# estimate, the Tikhonov solve
LADDER_SOLVES = 6
B, N, M = 1536, 12, 13


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters, warmup=5):
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
    """Least time (ms) for one [B, N, M] elimination on this card: the
    input read once, M and |pivot| written once; N steps of N*M divisions
    and (N-1)*M multiply-subtracts per system."""
    item = torch.finfo(dtype).bits // 8
    nbytes = (2 * B * N * M + B * N) * item
    flops = B * N * (M + 2 * (N - 1) * M)
    t_bytes = nbytes / PEAK_BYTES_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops \
        else "operations"


def kernel_phase(gk, dtype, tol):
    Mx = gj_inputs(dtype)
    out_k, piv_k = gk.gj_solve(Mx)
    out_p, piv_p = gk.gj_solve_reference(Mx)
    torch.cuda.synchronize()
    for a, b in ((out_k, out_p), (piv_k, piv_p)):
        if not torch.equal(torch.isnan(a), torch.isnan(b)):
            raise AssertionError(f"{dtype}: NaN systems differ")
    nan_sys = torch.isnan(out_k).flatten(1).any(1).nonzero().flatten()
    if nan_sys.tolist() != [5]:
        raise AssertionError(f"{dtype}: NaN in systems {nan_sys.tolist()}")
    fin = ~torch.isnan(out_p)
    err = max((out_k - out_p)[fin].abs().max().item(),
              (piv_k - piv_p)[~torch.isnan(piv_p)].abs().max().item())
    x_max = out_p[..., N:][fin[..., N:]].abs().max().item()
    if not err <= tol * x_max:
        raise AssertionError(
            f"{dtype}: kernel vs plain max|d| {err} > {tol} * {x_max}")
    A = Mx[..., :N].clone()
    A[5] = torch.eye(N, dtype=dtype, device="cuda")
    rhs = Mx[..., N:].clone()
    rhs[5] = 0.0
    ms = cuda_ms(lambda: gk.gj_solve(Mx), 200)
    plain_ms = cuda_ms(lambda: gk.gj_solve_reference(Mx), 20)
    library_ms = cuda_ms(lambda: torch.linalg.solve(A, rhs), 50)
    bound_ms, bound_by = gj_bound(dtype)
    print(f"phase kernel {str(dtype).split('.')[-1]}: [{B},{N},{M}] "
          f"max_abs_err={err:.3e} (bar {tol:g}*max|x|={tol * x_max:.3e}) "
          f"NaN systems {nan_sys.tolist()} ms={ms:.5f} plain_ms="
          f"{plain_ms:.5f} library_ms={library_ms:.5f} bound_ms="
          f"{bound_ms:.6f} ({bound_by})", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)


def run_main_path(rt, Timers, design, **kw):
    """Model -> analyze_unloaded -> solve_eigen -> analyze_cases (cold),
    then a warm analyze_cases with the kernel's launch count reset just
    before it."""
    gk = rt.gj_solve
    model = rt.Model(design, **kw)
    model.analyze_unloaded()
    fns, _ = model.solve_eigen(display=0)
    model.analyze_cases()
    gk.launches = 0
    with Timers() as tm:
        with tm.time("analyze_cases"):
            model.analyze_cases()
    launches = gk.launches
    rep = tm.report()
    return model, fns, launches, {k: rep[k]["total_s"] for k in rep}


def rao(model):
    zeta = model.zeta
    mask = np.abs(zeta) > 1e-3
    return np.abs(model.Xi) / np.where(mask, np.abs(zeta), np.inf)[:, None]


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this "
                 "script needs an NVIDIA card")
    card = card_line()
    print(card, flush=True)

    import raft_tpu_torch as rt
    from raft_tpu_torch.utils.profiling import Timers

    gk = rt.gj_solve
    t0 = time.perf_counter()
    gk.build(verbose=True)
    print(f"phase build: {gk.SOURCE} -> sm_90a in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    k64 = kernel_phase(gk, torch.float64, 1e-12)
    kernel_phase(gk, torch.float32, 1e-5)

    design = rt.designs.flagship(0.00625, 0.8, 12)
    model, fns, launches, times = run_main_path(rt, Timers, design)
    rep = model.solve_report
    trips = int(rep.iters.max())
    if model.nw != 128 or model.Xi.shape != (12, 6, 128):
        raise AssertionError(f"unexpected problem size {model.Xi.shape}")
    if not rep.converged.all() or rep.nonfinite.any():
        raise AssertionError(f"unhealthy cases: {rep}")
    if not np.isfinite(model.Xi).all():
        raise AssertionError("non-finite response")
    if launches != trips + LADDER_SOLVES:
        raise AssertionError(
            f"gj_solve launches {launches} != {trips} fixed-point trips + "
            f"{LADDER_SOLVES} ladder solves")
    cpu = rt.Model(rt.designs.flagship(0.00625, 0.8, 12), device="cpu")
    cpu.analyze_unloaded()
    cpu.analyze_cases()
    xi_rel = np.abs(model.Xi - cpu.Xi).max() / np.abs(cpu.Xi).max()
    if not xi_rel <= 1e-8:
        raise AssertionError(f"card vs CPU Xi rel {xi_rel} > 1e-8")
    print(f"phase main f64: nw={model.nw} cases={model.Xi.shape[0]} "
          f"eigen_hz={np.round(fns, 5).tolist()} trips={trips} "
          f"gj_launches={launches} host_prep_s={times['case_prep']:.4f} "
          f"dynamics_s={times['rao_solve']:.4f} analyze_cases_s="
          f"{times['analyze_cases']:.4f} xi_rel_vs_cpu={xi_rel:.3e} "
          f"iters={rep.iters.tolist()}", flush=True)

    m32, _, launches32, times32 = run_main_path(
        rt, Timers, rt.designs.flagship(0.00625, 0.8, 12),
        precision="float32")
    r64, r32 = rao(model), rao(m32)
    rao_abs = np.abs(r32 - r64).max()
    rao_rel = rao_abs / r64.max()
    if not (m32.solve_report.converged.all() and rao_rel <= 1e-4):
        raise AssertionError(f"f32 RAO L-inf rel {rao_rel} > 1e-4 or "
                             f"unconverged {m32.solve_report}")
    print(f"phase main f32: rao_linf={rao_abs:.3e} rao_linf_rel="
          f"{rao_rel:.3e} gj_launches={launches32} host_prep_s="
          f"{times32['case_prep']:.4f} dynamics_s="
          f"{times32['rao_solve']:.4f}", flush=True)

    kernels = [dict(
        name="gj_solve", route="cuda",
        source="raft_tpu_torch/csrc/gj_solve.cu",
        replaces="raft_tpu/pallas_kernels.py:150",
        launches=launches, **k64)]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
