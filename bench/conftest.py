"""Fixtures of the benchmark's own tests: small cells on the CPU, and the
card for the tests marked ``gpu`` (decided inside the fixture)."""
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


# what a cell of the paper CNN reports (PERF.md §7: its cells wait for
# a rate steady enough to bound); BENCHMARK.json gives the others'
FL_METRICS = (
    [{"name": "fl_rounds_per_s", "unit": "rounds/s"},
     {"name": "peak_mem_gib", "unit": "GiB"}, {"name": "setup_s", "unit": "s"}],
    [{"name": n, "unit": u} for n, u in (
        ("idle_share.fl", "%"), ("fl_round_mfu", "%"), ("fl_eval_ms", "ms"),
        ("prox_update_roofline.fl", "%"), ("ef_topk_roofline.fl", "%"))])


def small_cell(config: str, traffic: str, seed: int, device: str = "cpu",
               full: bool = False):
    """The configuration file ``config`` under the mix file ``traffic``,
    whether or not ``BENCHMARK.json`` holds the pair, reporting the
    metrics of that configuration's cells; unless ``full``, at a size a
    test run holds: the paper CNN over 2 x 3 devices with K = 2, L = 3;
    the decoder at 2 layers of width 64 and a vocabulary of 256, 2 x 16
    tokens, in float32."""
    from bench import core

    spec = core.manifest()
    like = [w["name"] for w in spec["workloads"] if w["config"] == config]
    read = lambda *p: json.loads((ROOT / "bench").joinpath(*p).read_text())
    cell = core.Cell(name=f"{config}.{traffic}", config_name=config,
                     traffic=traffic, config=read("configs", f"{config}.json"),
                     mix=read("workloads", f"{traffic}.json"), seed=seed,
                     device=device)
    if like:
        cell.end_to_end = [m for m in spec["end_to_end"]
                           if core.reports(m, like[0])]
        cell.per_layer = [m for m in spec["per_layer"]
                          if core.reports(m, like[0])]
    else:
        cell.end_to_end, cell.per_layer = FL_METRICS
    if full:
        return cell
    if cell.config["path"] == "fl_rounds":
        cell.config["federation"].update(
            m_teams=2, n_devices=3, samples_per_device=16,
            train_per_device=12, val_per_device=4)
        cell.config["algorithm"].update(k_team=2, l_local=3)
        cell.config["rounds"] = 4
        cell.mix.update(check_rounds=2, trace_from=1, trace_rounds=1)
    else:
        cell.config["model"].update(num_layers=2, d_model=64, num_heads=4,
                                    num_kv_heads=4, head_dim=16, d_ff=128,
                                    vocab_size=256)
        # float32 at this size: bfloat16's rounding on a 64-wide model is
        # not what the cell's limits were read from at published widths
        cell.config["precision"] = "float32"
        cell.mix.update(batch=2, seq_len=16)
    return cell


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "gpu: needs an NVIDIA card (skips without one)")


@pytest.fixture(autouse=True)
def one_thread():
    """Each benchmark test on one CPU thread: the suite runs in several
    worker processes at once, and threads beyond one a worker fight over
    the cores (the grouped convolutions of the CNN reference slow a
    hundredfold)."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")
