from repro_torch.core import bitmap
from repro_torch.core.bfs_local import (INF, BFSEngine, BFSResult, BFSRunner,
                                        LocalGraph, bfs_oracle,
                                        bfs_reference, build_local_graph,
                                        compact_indices,
                                        count_traversed_edges,
                                        engine_num_vertices, expand_edges,
                                        validate_roots)
from repro_torch.core.partition import PartitionedGraph, partition_graph
from repro_torch.core.scheduler import (PULL, PUSH, SchedulerConfig,
                                        choose_mode, choose_mode_host)
from repro_torch.core.vertex_program import (BFS, CC, INTEGRITY_MODES,
                                             PROGRAMS, SSSP, SV_CHECK,
                                             BudgetOverflowError,
                                             ConnectedComponentsRunner,
                                             IntegrityError,
                                             MultiSourceBFSRunner,
                                             SSSPRunner, VertexProgram,
                                             VertexProgramResult,
                                             VertexProgramRunner,
                                             component_labels, get_program,
                                             msbfs_reference, vp_reference)

__all__ = [
    "bitmap", "INF", "BFSEngine", "BFSResult", "BFSRunner", "LocalGraph",
    "bfs_oracle", "bfs_reference", "build_local_graph", "compact_indices",
    "count_traversed_edges", "engine_num_vertices", "expand_edges",
    "validate_roots", "PartitionedGraph", "partition_graph", "PULL", "PUSH", "SchedulerConfig", "choose_mode",
    "choose_mode_host", "BFS", "CC", "SSSP", "PROGRAMS", "INTEGRITY_MODES",
    "SV_CHECK", "IntegrityError", "BudgetOverflowError",
    "MultiSourceBFSRunner", "VertexProgram", "VertexProgramResult",
    "VertexProgramRunner", "ConnectedComponentsRunner", "SSSPRunner",
    "component_labels", "get_program", "msbfs_reference", "vp_reference",
]
