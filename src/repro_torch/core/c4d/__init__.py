"""C4D, the detection half of C4: telemetry windows, the C4a prefilter
(``agent``), the composite detector (``detector``) and the streaming master
(``master``). Copies of ``repro.core.c4d``'s NumPy modules; the accelerated
branch of each goes to ``core.torchsim`` instead of ``repro.core.jaxsim``."""
