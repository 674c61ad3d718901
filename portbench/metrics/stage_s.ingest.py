"""Mean seconds a sample in prepare_inputs (FASTQ, SAM and sheets to
run-dir artifacts), on the benchmark's clock around the call."""


def read(ctx):
    per = [s["ingest_s"] for s in ctx.samples if s["ingest_s"] is not None]
    return sum(per) / len(per) if per else None
