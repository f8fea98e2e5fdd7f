"""Wall-clock system simulator: heterogeneous devices and links, straggler
deadlines, and time to accuracy.

The engine counts rounds and bytes; this package turns them into
simulated seconds. A frozen ``SystemSpec`` models per-device compute
rates and per-tier LAN / WAN links (drawn per round);
``simulate_round`` prices each round along the hierarchy's critical path
from the byte model and, with a deadline, drops stragglers from the
round's masks before the algorithm's round runs. The engine assembles
the times into a host-side ``Timeline`` beside the ``CommLedger``:

    from repro_torch.scenarios import run_scenario
    res = run_scenario("table1/mnist/mclr/permfl", system="wan-cellular")
    res.sim_seconds        # cumulative simulated time at each eval point
    res.timeline.summary()

Profiles: ``uniform`` | ``lan-campus`` | ``wan-cellular`` | ``edge-iot``
(``SYSTEM_PROFILES``), each ``with_deadline(s)``-able.
"""
from repro_torch.system.simulate import sample_links, simulate_round
from repro_torch.system.spec import (SYSTEM_PROFILES, RoundWorkload,
                                     SystemSpec, get_profile, workload_for)
from repro_torch.system.timeline import Timeline

__all__ = ["SYSTEM_PROFILES", "RoundWorkload", "SystemSpec", "Timeline",
           "get_profile", "sample_links", "simulate_round", "workload_for"]
