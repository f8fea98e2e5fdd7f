"""The port's benchmark: one command runs one cell of ``BENCHMARK.json``.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix, path or
per-layer metric is a file of its own, found by the name that
``BENCHMARK.json`` gives it:

    configs/<config>.json     a model configuration as it is run
    workloads/<traffic>.json  a traffic mix: the parameters of one job
    paths/<path>.py           the code that runs a configuration's path
    metrics/<metric>.py       the reader of one per-layer metric

The yardsticks (``yardstick/``: peaks, kernel work, model FLOPs), the
traffic generators (``traffic/``) and the plain references
(``reference/``) are frozen copies that the measured program
(``repro_torch``) cannot change.
"""
