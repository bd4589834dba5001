"""The C4 system of the port: the C4D detection loop (``c4d``), its torch
backend (``torchsim``), the seeded fault/telemetry source (``faults``), and
the C4P side the fault drills drive (``c4p``, ``topology``, ``flowset``,
``netsim``) with the simulated cluster (``cluster``) and the Table-3 phases
(``phases``). The NumPy modules are copies of ``repro.core``'s, held equal to
them by ``tests/test_torch_detect.py`` and ``tests/test_torch_scenarios.py``."""
