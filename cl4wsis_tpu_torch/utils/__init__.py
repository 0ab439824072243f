from cl4wsis_tpu_torch.utils.logging import Logger, StepTimer

__all__ = ["Logger", "StepTimer"]
