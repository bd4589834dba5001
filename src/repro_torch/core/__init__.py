"""The C4 system of the port: the C4D detection loop (``c4d``), its torch
backend (``torchsim``) and the seeded fault/telemetry source (``faults``).
The NumPy modules are copies of ``repro.core``'s, held equal to them by
``tests/test_torch_detect.py``."""
