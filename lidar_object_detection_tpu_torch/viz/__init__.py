"""Host-side drawing and 3D scene export: the colour tables, mask overlays,
box outlines, depth-map figures (``overlay``), and the ASCII PLY writer
(``export``).  Written with numpy and the port's PNG writer; no
matplotlib, PIL, OpenCV or Open3D."""
