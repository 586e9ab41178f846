# cloudpickle 3.1.2, vendored: these two files as released, but for this
# comment (BSD-3-Clause; ``LICENSE`` beside them). The runtime ships
# functions and classes by value with it, and a machine the port runs on
# need not have cloudpickle installed.
from . import cloudpickle
from .cloudpickle import *  # noqa

__doc__ = cloudpickle.__doc__

__version__ = "3.1.2"

__all__ = [  # noqa
    "__version__",
    "Pickler",
    "CloudPickler",
    "dumps",
    "loads",
    "dump",
    "load",
    "register_pickle_by_value",
    "unregister_pickle_by_value",
]
