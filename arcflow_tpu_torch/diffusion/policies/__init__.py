from .arcflow import ArcFlowPolicy

__all__ = ['ArcFlowPolicy']
