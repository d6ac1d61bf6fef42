"""The loops that drive a window. A traffic mix names its loop by
``"loop"``; the module of that name here has ``run(call, seconds, keep,
sync, span)``."""
