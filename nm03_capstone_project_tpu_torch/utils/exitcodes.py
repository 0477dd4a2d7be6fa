"""Exit codes that one of the port's programs gives and another reads.

Free of torch and numpy at import.
"""

# nm03-serve's exit code when its port is held (errno EADDRINUSE on Linux):
# the fleet's restart relaunches on that port while the exit lasts
ADDRESS_IN_USE_EXIT = 98
