"""repro_torch.parallel — distributed pieces of the LM substrate.

Port of ``repro.parallel``: ``sharding`` (the partition rules and the
port's block layout), ``seqscan`` (the sequence-parallel linear
recurrences and their halos), ``loss`` (the chunked cross-entropy,
meshless or summed over a mesh), ``compression`` (int8 error-feedback
``compressed_psum``) and ``pipeline`` (the GPipe ``pipeline_apply``).
"""
