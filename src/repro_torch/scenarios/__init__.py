"""Scenario registry and runner of the port: PerMFL and the six Table-1
baselines on all 95 of the reference's cells, run one at a time or swept
over a grid and seeds, with or without run telemetry."""
from repro_torch.scenarios.registry import (SCENARIOS, families,
                                            get_scenario, register)
from repro_torch.scenarios.runner import (ScenarioBuild, build_scenario,
                                          run_scenario, sweep_scenario)
from repro_torch.scenarios.spec import (PAPER_HP, AlgoSpec, DataSpec,
                                        FLScenario, ModelSpec)

__all__ = ["AlgoSpec", "DataSpec", "FLScenario", "ModelSpec", "PAPER_HP",
           "SCENARIOS",
           "ScenarioBuild", "build_scenario", "families", "get_scenario",
           "register", "run_scenario", "sweep_scenario"]
