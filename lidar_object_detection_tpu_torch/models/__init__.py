"""Detector models of the port: the stub, YOLO11-seg (``models.yolo``)
and the pure-LiDAR PointPillars (``models.pointpillars``)."""
