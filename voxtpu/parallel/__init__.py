"""Multi-device / multi-host execution (SURVEY.md §5).

Single-controller sharding (one process, many devices): sharded_vox /
sharded_jfa / sharded_fit. Multi-controller
bootstrap (many processes / hosts): `distributed`.
"""

from voxtpu.parallel.distributed import (global_from_local, global_mesh,
                                         init_distributed,
                                         local_from_global,
                                         shutdown_distributed)

__all__ = [
    "global_from_local",
    "global_mesh",
    "init_distributed",
    "local_from_global",
    "shutdown_distributed",
]
