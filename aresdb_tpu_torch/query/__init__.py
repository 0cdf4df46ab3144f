"""AQL/SQL query engine: parse → compile → TPU execution → postprocess."""
