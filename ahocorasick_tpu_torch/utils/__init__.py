from . import errors, search  # noqa: F401
