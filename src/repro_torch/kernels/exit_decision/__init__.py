from repro_torch.kernels.exit_decision.kernel import exit_decision_cuda
from repro_torch.kernels.exit_decision.ref import exit_decision_ref

__all__ = ["exit_decision_cuda", "exit_decision_ref"]
