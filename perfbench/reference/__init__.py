"""Plain fp32 PyTorch reference of the benchmark's training step; imports
nothing of the program (``test_perfbench_isolation.py`` holds it so)."""
