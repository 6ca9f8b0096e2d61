"""PyTorch / CUDA port of ``sl_hwgat_tpu`` for NVIDIA Hopper.

Serves HWGATE, HGATE, WGATE and GATE (eval forward, ``serve.Predictor`` and
``serve.BatchingQueue``) and trains them (``train.loop``, and the command
line ``cli`` behind ``main_torch.py``), with the windowed
and the banded graph attention and their gradients as hand-written CUDA
kernels (``csrc/window_attention_{fwd,bwd}.cu``,
``csrc/banded_attention_{fwd,bwd}.cu``). Module names mirror the JAX package.
The package imports no JAX and nothing of ``sl_hwgat_tpu``.
"""
