"""The yardstick's arithmetic: the H100's published peaks (``peaks``), the
model FLOPs of a pair or a train step (``flops``) and each hand kernel's
least bytes and operations (``kernels``). Nothing here reads a module of
``msnets_tpu_torch``."""
