"""The benchmark of uvltrack_tpu_torch, the PyTorch and CUDA port, on CUDA
cards: one run of one cell of BENCHMARK.json (run.py), the yardstick it
measures with (traffic/, costs/, metrics/, roles/, profile.py), the plain
float32 reference and the comparison that decides `correct` (reference/,
check.py), and the readings the comparison's limits were set from
(readings.py, faults.py). It imports the port and never JAX or the JAX
package (guard.py)."""
