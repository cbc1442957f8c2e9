"""The benchmark of raft_tpu_torch on NVIDIA GPUs: one command runs one
cell (a configuration under a traffic mix) once, from the files that
BENCHMARK.json names.  See cardbench/run.py."""
