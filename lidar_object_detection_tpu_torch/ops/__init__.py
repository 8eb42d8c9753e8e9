"""Packed masks, erosion, NMS, resize weights, the depth-map scatter, the
exact assignment solver, and the CUDA kernels with their plain twins
(``inside_counts``, ``mask_assembly``, ``nms``, ``lap``).  The kernels are
built on first use (``kernel_lib``), never at import."""
