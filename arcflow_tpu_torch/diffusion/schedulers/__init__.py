"""Inference-time flow schedulers: counterpart of
``arcflow_tpu/diffusion/schedulers`` for the Euler ODE and the SDE,
registered in ``SCHEDULERS`` under the JAX names. The DPM-solver family
and the FlowAdapter dispatcher wait for their slice."""

from ...registry import SCHEDULERS
from .flow_euler_ode import FlowEulerODEScheduler, shift_sigmas
from .flow_sde import FlowSDEScheduler

__all__ = ['FlowEulerODEScheduler', 'FlowSDEScheduler', 'SCHEDULERS',
           'shift_sigmas']
