"""The LM stack: ``config`` (``ModelConfig``, ``BlockSpec``), ``layers``
(norms, rotary embedding, chunked and decode attention, dense and MoE FFNs
with the gather and the all-to-all dispatch, the Mamba-2 SSD mixer) and
``model`` (parameters, the training forward and backward through
``loss_fn``, ``prefill`` and ``decode_step``).

The functions are plain PyTorch on dict trees of tensors, as the reference's
are on pytrees, and run on DTensors under a mesh (``distributed.ctx``); the
reference computes the LM with XLA ops and no Pallas kernel, so the port
launches none of its CUDA kernels here.
"""
