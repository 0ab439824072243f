from cl4wsis_tpu_torch.utils.logging import Logger, StepTimer
from cl4wsis_tpu_torch.utils.visualize import (Label2Color, ade_cmap,
                                               cityscapes_cmap, color_map,
                                               denorm, label_to_color_image,
                                               sample_image, voc_cmap)

__all__ = ["Logger", "StepTimer", "Label2Color", "denorm", "voc_cmap",
           "ade_cmap", "cityscapes_cmap", "color_map",
           "label_to_color_image", "sample_image"]
