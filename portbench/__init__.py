"""The benchmark of brutefir_tpu_torch: ``python3 portbench/run.py
--workload <cell> --seed <n> --seconds <s> --trace <0|1>`` from the
root of a checkout (BENCHMARK.json names the cells)."""
