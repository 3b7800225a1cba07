from convolutional_codes_tpu_torch.models.tables import CodeTables, code_tables

__all__ = ["CodeTables", "code_tables"]
