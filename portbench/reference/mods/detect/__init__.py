# Frozen copy of mods_tpu_torch/detect/__init__.py, kept as the benchmark's plain reference
# (see portbench/reference/__init__.py); later edits to the port do not reach it.
