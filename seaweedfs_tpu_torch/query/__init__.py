"""Structured queries over needle content (weed/query).

Counterpart of seaweedfs_tpu/query/__init__.py.
"""

from .json_query import (Query, filter_record, get_path, query_csv,
                         query_json_lines)

__all__ = ["Query", "filter_record", "get_path", "query_csv",
           "query_json_lines"]
