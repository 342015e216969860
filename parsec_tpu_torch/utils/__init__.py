from . import mca_param
from . import debug
from . import vpmap
