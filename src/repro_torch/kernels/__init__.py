"""Hand-written Hopper kernels (``csrc/``), their wrappers, the plain
versions (``ref.py``) and the device dispatch (``ops.py``)."""
