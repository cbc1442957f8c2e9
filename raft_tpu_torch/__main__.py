"""Command-line entry point (the port's ``raft_tpu/__main__.py``).

``python -m raft_tpu_torch design.yaml [options]`` — one-shot full
analysis (the reference's ``python raft_model.py`` __main__ path,
reference raft/raft_model.py:1140-1147, as a proper CLI).  The case
dynamics runs on ``cuda`` unless ``--device cpu`` is given; without a
card the default raises.

``warmup`` and ``serve`` (the serving engine's ahead-of-time warm-up and
its request loop) raise ``NotImplementedError``: the serve stack is not
ported yet (ROADMAP.md, queue 1 step 12).
"""

import argparse
import sys


def _device(text):
    """``cuda``, ``cuda:N`` or ``cpu``."""
    head, _, index = text.partition(":")
    if head == "cpu" and not index or head == "cuda" and (
            not index or index.isdigit()):
        return text
    raise argparse.ArgumentTypeError(
        f"device must be 'cuda', 'cuda:N' or 'cpu', got {text!r}")


def _analyze_main(argv):
    p = argparse.ArgumentParser(
        prog="raft_tpu_torch",
        description="Frequency-domain FOWT analysis (RAFT on PyTorch and "
                    "CUDA)",
    )
    p.add_argument("design", help="design YAML/pickle path")
    p.add_argument("--plot", action="store_true",
                   help="save geometry + response-PSD figures")
    p.add_argument("--ballast", type=int, default=0, choices=[0, 1, 2],
                   help="ballast trim mode (1=fill levels, 2=densities)")
    p.add_argument("--precision", choices=["float32", "float64"],
                   default=None, help="working precision of the dynamics")
    p.add_argument("--device", type=_device, default="cuda",
                   help="device of the batched case solve: cuda (the "
                        "default), cuda:N or cpu")
    p.add_argument("--bem", action="store_true",
                   help="run the native BEM solver on potMod members")
    args = p.parse_args(argv)

    from raft_tpu_torch.model import run_raft

    return run_raft(
        args.design, plot=int(args.plot), ballast=args.ballast,
        precision=args.precision, run_native_bem=args.bem,
        device=args.device,
    )


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in ("warmup", "serve"):
        from raft_tpu_torch.model import _not_ported

        raise _not_ported(f"'python -m raft_tpu_torch {argv[0]}' (the "
                          "serve stack)", 12)
    return _analyze_main(argv)


if __name__ == "__main__":
    main()
