"""Rapids: the dataframe-algebra protocol (counterpart of
h2o3_tpu/rapids/; the reference: water/rapids/).

Clients send Lisp-like statements ("(+ (cols fr [0]) 5)"); `parse`
turns them into ASTs and `exec_rapids` evaluates them over DKV frames
with the prims of eval.py and prims_ext.py.
"""

from h2o3_tpu_torch.rapids.eval import Env, Session, exec_rapids  # noqa: F401
from h2o3_tpu_torch.rapids.parser import parse  # noqa: F401
