from cl4wsis_tpu_torch.wss.modules import PeakGenerator, PseudoLabeler

__all__ = ["PeakGenerator", "PseudoLabeler"]
