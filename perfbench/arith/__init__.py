"""The benchmark's frozen arithmetic: the H100's data-sheet peaks and the
bytes and operations each kernel needs.

These are copies, rewritten here, of the program's own figures
(``repro_torch.analysis.roofline`` and the kernel bounds of
``chip_smoke.py``), so that a change to the program cannot move the
yardstick it is measured against.  Nothing here imports the program.
"""
