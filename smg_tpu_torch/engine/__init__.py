"""Serving engine of the PyTorch port: runner, scheduler, engine facade."""
