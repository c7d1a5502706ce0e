"""Multi-process solves over ``torch.distributed`` (counterpart of
``qpth_tpu/parallel``): batch sharding (:func:`solve_qp_sharded`), the
start-up helpers (:func:`init_multihost`, :func:`local_batch_slice`) and
intra-QP tensor parallelism (:func:`prefactor_qp_tp`, :func:`solve_qp_tp`,
:func:`factor_solve_hybrid_tp`)."""

from .intra import (factor_solve_hybrid_tp, prefactor_qp_tp,  # noqa: F401
                    solve_hybrid_tp, solve_qp_tp)
from .multihost import init_multihost, local_batch_slice  # noqa: F401
from .sharding import (batch_mesh, batch_sharding,  # noqa: F401
                       solve_qp_sharded)
