"""PyTorch / CUDA port of ``sl_hwgat_tpu`` for NVIDIA Hopper.

Serves HWGATE (eval forward, ``serve.Predictor`` and ``serve.BatchingQueue``)
and trains it (``train.loop``), with the windowed graph attention and its
gradient as hand-written CUDA kernels (``csrc/window_attention_fwd.cu``,
``csrc/window_attention_bwd.cu``). Module names mirror the JAX package.
The package imports no JAX and nothing of ``sl_hwgat_tpu``.
"""
