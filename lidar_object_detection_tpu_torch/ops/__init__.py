"""Packed masks, erosion, NMS, resize weights, and the CUDA kernels with
their plain twins (``inside_counts``, ``mask_assembly``, ``nms``).  The
kernels are built on first use (``kernel_lib``), never at import."""
