from cl4wsis_tpu_torch.models.assembly import CL4WSISModel, make_model
from cl4wsis_tpu_torch.models.tta import test_augmentation

__all__ = ["CL4WSISModel", "make_model", "test_augmentation"]
