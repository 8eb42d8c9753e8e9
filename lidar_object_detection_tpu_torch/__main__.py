from lidar_object_detection_tpu_torch.pipelines.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
