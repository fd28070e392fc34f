from .arcflow import ArcFlowImitationDataFree, multistep_train_loss
from .gaussian_flow import GaussianFlow
from .integrator import momentum_integration, policy_average_u
from .losses import DiffusionMSELoss
from .policies import ArcFlowPolicy
from .sampler import ContinuousTimeStepSampler

__all__ = ['ArcFlowImitationDataFree', 'ArcFlowPolicy',
           'ContinuousTimeStepSampler', 'DiffusionMSELoss', 'GaussianFlow',
           'momentum_integration', 'multistep_train_loss',
           'policy_average_u']
