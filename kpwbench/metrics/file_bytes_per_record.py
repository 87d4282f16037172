"""Bytes of published Parquet per committed record, over every file the
run published (after ``close()`` the published files hold exactly the
committed records)."""


def read(run):
    records = run.committed_at(float("inf"))
    if not run.files or not records:
        return None
    return sum(size for _, size in run.files) / records
