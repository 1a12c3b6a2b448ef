"""BAL dataset ingestion."""
