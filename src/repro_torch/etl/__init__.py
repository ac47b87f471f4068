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
from .transport import (  # noqa: F401
    SocketServer,
    SocketTransport,
    Transport,
    TransportClosed,
    connect,
    decode_event,
    decode_record,
    decode_snapshot,
    encode_event,
    encode_record,
    encode_snapshot,
    local_pipe,
)
#: replication exports resolve lazily (PEP 562): the module doubles as the
#: ``python -m repro_torch.etl.replication`` CLI, and an eager import here
#: would make runpy warn about re-executing an already-imported module
_REPLICATION_NAMES = (
    "ControlLedger",
    "DataPlane",
    "FencedAppendError",
    "FollowerNode",
    "LeaderLease",
    "LeaderLost",
    "LeaderNode",
    "elect_leader",
    "promote",
)


def __getattr__(name):
    if name in _REPLICATION_NAMES:
        from . import replication

        return getattr(replication, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
