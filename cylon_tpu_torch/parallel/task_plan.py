"""The task overlay's old import path (counterpart of
cylon_tpu.parallel.task_plan): it lives in `cylon_tpu_torch.plan.tasks`,
next to the logical plan it serves."""
from ..plan.tasks import LogicalTaskPlan, task_exchange  # noqa: F401

__all__ = ["LogicalTaskPlan", "task_exchange"]
