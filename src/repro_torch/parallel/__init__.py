"""repro_torch.parallel — distributed pieces of the LM substrate.

Port of ``repro.parallel``; so far ``seqscan`` (the sequence-parallel
linear recurrences).  Sharding rules, compression and the pipeline wait
for ``ROADMAP.md`` queue 1 item 8e.
"""
