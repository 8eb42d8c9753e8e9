"""Training: the optimizer's arithmetic (:mod:`.optim`) and the YOLO11-seg
trainer (:mod:`.train`), on one card."""
