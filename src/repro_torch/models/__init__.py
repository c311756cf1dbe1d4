"""The LM stack's serving half: ``config`` (``ModelConfig``, ``BlockSpec``),
``layers`` (norms, rotary embedding, chunked and decode attention, dense and
MoE FFNs, the Mamba-2 SSD mixer) and ``model`` (parameters, the forward
``loss_fn``, ``prefill`` and ``decode_step``).

The functions are plain PyTorch on dict trees of tensors, as the reference's
are on pytrees; the reference computes the LM with XLA ops and no Pallas
kernel, so the port launches none of its CUDA kernels here.  The backward
pass (remat, ``scan_levels``) comes with the training slice.
"""
