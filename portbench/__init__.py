"""The port's benchmark: one cell of ``BENCHMARK.json`` run once by
``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``. See README.md."""
