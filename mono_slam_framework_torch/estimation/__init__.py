from mono_slam_framework_torch.estimation.initializer import Initializer, InitResult

__all__ = ["Initializer", "InitResult"]
