"""The plain references that decide ``correct``. A traffic mix names its
check by ``"check"``; the module of that name here has ``LIMITS`` and
``check(u, v, n, mask, state)``. Nothing here imports the program."""
