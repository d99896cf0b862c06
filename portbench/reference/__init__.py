"""The plain reference of the benchmark: the ezorzin/SDF3D shader (sphere
trace, soft shadow, central normals, Blinn-Phong) and the fit step's
implicit-function gradient with Adam, in plain PyTorch.

It imports torch, numpy and the standard library only: nothing of the
program under test, nothing of the JAX package.  Every function takes the
dtype it computes in, so the same code serves as the control (the
reference computed in bfloat16).
"""
