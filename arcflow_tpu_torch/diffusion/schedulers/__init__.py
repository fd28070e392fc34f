"""Inference-time flow schedulers: counterpart of
``arcflow_tpu/diffusion/schedulers`` for the Euler ODE and the SDE. The
DPM-solver family and the FlowAdapter dispatcher wait for their slice."""

from .flow_euler_ode import FlowEulerODEScheduler, shift_sigmas
from .flow_sde import FlowSDEScheduler

# stands in for the JAX package's ``SCHEDULERS`` registry lookup by
# ``name + 'Scheduler'``
SCHEDULERS = {cls.__name__: cls
              for cls in (FlowEulerODEScheduler, FlowSDEScheduler)}

__all__ = ['FlowEulerODEScheduler', 'FlowSDEScheduler', 'SCHEDULERS',
           'shift_sigmas']
