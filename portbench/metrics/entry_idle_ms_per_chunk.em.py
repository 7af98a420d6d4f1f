"""entry_idle_ms_per_chunk.em: The card's idle time a traced
chunk while the host was in ``train()``'s own spans (fetch, log,
callbacks, persist) but the chunk trainer's call, or outside every span:
what the entry point's work between chunks costs the card."""

from portbench import spans

LAYER = "Entry point"
UNIT = "ms"
MOVES = "em_samples_per_s"


def read(ctx: dict):
    return spans.readings(ctx.get("spans") or {}).get("entry_idle_ms_per_chunk")
