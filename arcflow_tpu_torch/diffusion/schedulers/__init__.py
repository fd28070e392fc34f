"""Inference-time flow schedulers: counterpart of
``arcflow_tpu/diffusion/schedulers``, registered in ``SCHEDULERS`` under
the JAX names: the Euler ODE, the SDE, the stateful high-order solvers
(DPM-Solver++, UniPC, DEIS, SA-Solver) and the ``FlowAdapterScheduler``
dispatcher."""

from ...registry import SCHEDULERS
from .flow_dpmsolver import (FlowAdapterScheduler, FlowDEISScheduler,
                             FlowDPMSolverScheduler, FlowSASolverScheduler,
                             FlowUniPCScheduler)
from .flow_euler_ode import FlowEulerODEScheduler, shift_sigmas
from .flow_sde import FlowSDEScheduler

__all__ = ['FlowAdapterScheduler', 'FlowDEISScheduler',
           'FlowDPMSolverScheduler', 'FlowEulerODEScheduler',
           'FlowSASolverScheduler', 'FlowSDEScheduler', 'FlowUniPCScheduler',
           'SCHEDULERS', 'shift_sigmas']
