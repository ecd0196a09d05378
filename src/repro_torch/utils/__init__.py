# Tree helpers, random keys, weight conversion and structured logging.
