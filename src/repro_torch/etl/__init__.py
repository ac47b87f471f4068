from .events import CDCEvent, ColumnarChunk, EventSource, columnarize  # noqa: F401
from .control import (  # noqa: F401
    ControlEvent,
    ControlReplayError,
    Freeze,
    MatrixEdit,
    PlanPublished,
    SchemaAdded,
    SchemaEvolved,
    Thaw,
    VersionDeleted,
    replay_control_log,
)
from .plan import ColdColumn, PlanEpoch, PlanManager, TieringPolicy  # noqa: F401
from .engines import (  # noqa: F401
    ENGINES,
    BlockDense,
    BlocksEngine,
    CanonicalRow,
    FusedEngine,
    MappingEngine,
    ShardedEngine,
    TriagedChunk,
    densify_chunk_dicts,
    make_engine,
    register_engine,
)
from .metl import METLApp  # noqa: F401
from .batcher import CanonicalBatcher, make_token_batch  # noqa: F401
from .pipeline import (  # noqa: F401
    BatcherSink,
    CollectSink,
    EventChunkSource,
    ListSource,
    Pipeline,
    PipelineStats,
    RowSink,
    ScriptedControlSource,
    Source,
    TableSink,
    TokenizerSink,
)
from .cluster import Cluster, ClusterStats  # noqa: F401
