"""The networks: netM (md_generator), netG (deepfill_c2), the pipeline
(editline2)."""
