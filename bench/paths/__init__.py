"""The code that runs each path, one module a path, named by a
configuration's ``path``: each defines ``Path(cell)`` with ``inputs``,
``setup``, ``window``, ``traced``, ``release``, ``reference``, ``compare``
and ``check``."""
