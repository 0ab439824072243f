from cl4wsis_tpu_torch.metrics.stream import StreamSegMetrics
from cl4wsis_tpu_torch.metrics.voc_ap import InstanceAPAccumulator, ins_map_iou, mask_iou

__all__ = ["StreamSegMetrics", "InstanceAPAccumulator", "ins_map_iou", "mask_iou"]
