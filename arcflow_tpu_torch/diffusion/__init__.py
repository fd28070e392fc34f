from .arcflow import (ArcFlowImitation, ArcFlowImitationBase,
                      ArcFlowImitationDataFree, multistep_train_loss)
from .gaussian_flow import GaussianFlow
from .gmflow import (GMFlow, gmflow_posterior, gmflow_posterior_mean,
                     probabilistic_guidance)
from .integrator import momentum_integration, policy_average_u
from .losses import DiffusionMSELoss, GMFlowNLLLoss
from .policies import ArcFlowPolicy
from .sampler import ContinuousTimeStepSampler
from .schedulers import (FlowDPMSolverScheduler, FlowEulerODEScheduler,
                         FlowSDEScheduler, FlowUniPCScheduler)

__all__ = ['ArcFlowImitation', 'ArcFlowImitationBase',
           'ArcFlowImitationDataFree', 'ArcFlowPolicy',
           'ContinuousTimeStepSampler', 'DiffusionMSELoss',
           'FlowDPMSolverScheduler', 'FlowEulerODEScheduler',
           'FlowSDEScheduler', 'FlowUniPCScheduler', 'GMFlow',
           'GMFlowNLLLoss', 'GaussianFlow', 'gmflow_posterior',
           'gmflow_posterior_mean', 'momentum_integration',
           'multistep_train_loss', 'policy_average_u',
           'probabilistic_guidance']
