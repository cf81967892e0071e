"""Plain float32 PyTorch reference of the measured paths.

A frozen copy of the mathematics of the matching-space feature stage
(``features``), of MS-GCNet and MS-PSMNet (``models``) and of the train
step's loss and Adam update (``train``). It imports nothing of
``msnets_tpu_torch`` or of the JAX package and takes nothing the port
derived: it is handed the raw pairs, the raw targets and the seed's
unfolded weights, and works out padding, features, BN and the rest again.
``control`` holds the lower-precision variant used only to show that the
comparison fails it.
"""
