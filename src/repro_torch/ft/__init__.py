from .straggler import StragglerMonitor
