"""The trainers: train_synthetic (the YOLO-pose models) and train_reid
(the learned Re-ID head), run as python -m posebyte_tpu_torch.scripts.NAME."""
