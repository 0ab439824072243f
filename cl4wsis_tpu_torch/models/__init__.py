from cl4wsis_tpu_torch.models.assembly import CL4WSISModel, make_model

__all__ = ["CL4WSISModel", "make_model"]
