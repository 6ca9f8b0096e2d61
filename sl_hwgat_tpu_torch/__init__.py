"""PyTorch / CUDA port of ``sl_hwgat_tpu`` for NVIDIA Hopper.

Serves HWGATE (eval forward, ``serve.Predictor`` and ``serve.BatchingQueue``)
with the windowed graph attention as a hand-written CUDA kernel
(``csrc/window_attention_fwd.cu``). Module names mirror the JAX package.
The package imports no JAX and nothing of ``sl_hwgat_tpu``.
"""
