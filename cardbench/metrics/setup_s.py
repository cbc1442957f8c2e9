"""setup_s: seconds from the start of the process to the start of the
window (imports, CUDA context, building the system from the seed, kernel
builds or loads, warm-up), by the host clock."""


def read(run):
    return run.setup_s
