"""The plain reference of the benchmark's training cells: plain PyTorch in
float32 (``model.py``), its first steps (``train.py``) and the control
one precision lower (``control.py``). It imports neither JAX, nor the
JAX package, nor anything of the program."""
