from .heartbeat import HeartbeatRegistry  # noqa: F401
