"""Plain PyTorch references of the benchmark's configurations.

Each configuration `<name>` has its reference in `<name>.py`, which the
harness finds by the configuration's name.  The references follow the
published layer equations (OpenPCDet's SECOND / CenterPoint, GLENet's
KL-label head) and the budgets the configuration states, in float32 with
TF32 off, and import nothing of the program under test: they take only the
inputs and the weights the benchmark makes from the seed.
"""
