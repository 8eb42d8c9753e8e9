from lidar_object_detection_tpu_torch.eval.statistics import (
    CarStatistics,
    analyze_master_csv,
    append_to_master_csv,
    format_summary_table,
    frame_statistics,
    summarize,
)
from lidar_object_detection_tpu_torch.eval.erosion_study import (
    analyze as analyze_erosion_study,
    join_runs,
    run_erosion_study,
)
from lidar_object_detection_tpu_torch.eval.xlsx import (
    export_erosion_workbook,
    read_xlsx,
    write_xlsx,
)

__all__ = [
    "CarStatistics",
    "analyze_master_csv",
    "append_to_master_csv",
    "format_summary_table",
    "frame_statistics",
    "summarize",
    "analyze_erosion_study",
    "join_runs",
    "run_erosion_study",
    "export_erosion_workbook",
    "read_xlsx",
    "write_xlsx",
]
