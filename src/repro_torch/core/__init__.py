from repro_torch.core import bitmap
from repro_torch.core.bfs_local import (INF, BFSEngine, LocalGraph,
                                        bfs_oracle, build_local_graph,
                                        compact_indices,
                                        count_traversed_edges,
                                        engine_num_vertices, expand_edges,
                                        validate_roots)
from repro_torch.core.scheduler import (PULL, PUSH, SchedulerConfig,
                                        choose_mode_host)
from repro_torch.core.vertex_program import (BFS, MultiSourceBFSRunner,
                                             VertexProgram,
                                             VertexProgramResult,
                                             VertexProgramRunner,
                                             msbfs_reference, vp_reference)

__all__ = [
    "bitmap", "INF", "BFSEngine", "LocalGraph", "bfs_oracle",
    "build_local_graph", "compact_indices", "count_traversed_edges",
    "engine_num_vertices", "expand_edges", "validate_roots", "PULL", "PUSH",
    "SchedulerConfig", "choose_mode_host", "BFS",
    "MultiSourceBFSRunner", "VertexProgram", "VertexProgramResult",
    "VertexProgramRunner", "msbfs_reference", "vp_reference",
]
