from .heartbeat import HeartbeatRegistry  # noqa: F401
from .straggler import StragglerDetector  # noqa: F401
from .elastic import ElasticPlan, plan_remesh  # noqa: F401
