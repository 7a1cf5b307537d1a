"""The benchmark of the PyTorch and CUDA port (`stfem_tpu_torch`): one
command runs one cell once (`python3 benchmark/run.py --workload <name>
--seed <n> --seconds <s> --trace <0|1>`); BENCHMARK.json at the
checkout's root names the cells.  The CPU tests: `python -m pytest
benchmark/tests -q`."""
