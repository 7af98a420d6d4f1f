"""trainer_idle_ms_per_chunk.em: The card's idle time a traced
chunk while the host was in the chunk trainer's spans (``train.chunk``,
``trainer.draw``, ``trainer.launch``): the staging and launch of the
fused kernel."""

from portbench import spans

LAYER = "Chunk trainer"
UNIT = "ms"
MOVES = "em_samples_per_s"


def read(ctx: dict):
    return spans.readings(ctx.get("spans") or {}).get("trainer_idle_ms_per_chunk")
