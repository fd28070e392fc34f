from .arcflow import ArcFlowImitationDataFree
from .integrator import momentum_integration
from .policies import ArcFlowPolicy
from .sampler import ContinuousTimeStepSampler

__all__ = ['ArcFlowImitationDataFree', 'ArcFlowPolicy',
           'ContinuousTimeStepSampler', 'momentum_integration']
