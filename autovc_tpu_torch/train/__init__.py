"""Training subsystem (counterpart of ``autovc_tpu/train``): the AutoVC
generator's, the GE2E speaker encoder's and the WaveRNN vocoder's
datasets and loops, the schedules and optimizer, and the dispatcher
``VoiceConverter.train`` calls."""
from __future__ import annotations

from autovc_tpu_torch.train import data, loop, schedules  # noqa: F401


def train_model(vc, model_type: str, data_path, **kwargs):
    """Dispatcher used by ``VoiceConverter.train`` (the JAX package's
    ``train_model``).  Extra kwargs go to the training loop; dataset
    kwargs: ``preprocess``, ``preprocess_args``, ``data_path_excluded``,
    and for the auto-encoder ``cut``, ``one_hot``,
    ``use_mean_speaker_embedding``.  For ``speaker_encoder``,
    ``data_path`` is a dict speaker name -> path or list of paths; a
    stack deeper than the CUDA kernels carry raises before the dataset is
    built.

    ``source_examples`` / ``target_examples`` (the auto-encoder only;
    auto_encoder/model.py:347-357): after each epoch the converter takes
    the epoch's generator, lstm2's packed kernel weights rebuilt from it,
    and converts every source into every target (``convert_multiple``),
    logging the audio to a live wandb run or writing it under
    ``results/training_examples/``."""
    if model_type not in ("auto_encoder", "speaker_encoder", "vocoder"):
        raise ValueError(f"'{model_type}' is not a supported model_type")
    source_examples = kwargs.pop("source_examples", None)
    target_examples = kwargs.pop("target_examples", None)
    dataset_keys = {"preprocess", "preprocess_args", "cut",
                    "data_path_excluded", "one_hot",
                    "use_mean_speaker_embedding"}
    ds_kwargs = {k: kwargs.pop(k) for k in list(kwargs) if k in dataset_keys}
    if model_type == "speaker_encoder":
        loop.check_se_depth(vc.SE.params)
        dataset = data.SpeakerEncoderDataset(
            data_path, cfg=vc.SE.config, verbose=vc.verbose, **ds_kwargs)
        params, info = loop.train_speaker_encoder(
            vc.SE.params, dataset, vc.SE.config, logger=vc.logger,
            verbose=vc.verbose, speakers=vc.speakers,
            start_step=vc.SE.step, **kwargs)
        vc.SE.params = params
        vc.SE.step = info["step"]
        return info
    if model_type == "vocoder":
        dataset = data.VocoderDataset(
            data_path, mel_cfg=vc.AE.config.spectrogram,
            vocoder_cfg=vc.vocoder.config, verbose=vc.verbose,
            **{k: v for k, v in ds_kwargs.items()
               if k in ("preprocess", "preprocess_args",
                        "data_path_excluded")})
        params, info = loop.train_vocoder(
            vc.vocoder.params, dataset, vc.vocoder.config, logger=vc.logger,
            verbose=vc.verbose, start_step=vc.vocoder.step, **kwargs)
        vc.vocoder.params = params
        vc.vocoder.step = info["step"]
        return info
    dataset = data.AutoEncoderDataset(
        data_path, speaker_encoder=vc.SE.params,
        speaker_encoder_params=vc.SE.config, speakers=vc.speakers,
        cfg=vc.AE.config, verbose=vc.verbose, device=vc.device, **ds_kwargs)
    on_epoch_end = None
    if source_examples and target_examples:
        def on_epoch_end(epoch, params):
            vc.AE.params = params
            vc._pack_weights("auto_encoder")
            live = getattr(vc.logger, "run", None) is not None
            vc.convert_multiple(
                source_examples, target_examples,
                save_dir="wandb" if live else "training_examples",
                audio_log_dict={"epoch": epoch})

    params, ema, info = loop.train_autoencoder(
        vc.AE.params, dataset, vc.AE.config, logger=vc.logger,
        verbose=vc.verbose, start_step=vc.AE.step,
        on_epoch_end=on_epoch_end, **kwargs)
    vc.AE.params = params
    vc.AE.step = info["step"]
    vc.AE.extras["ema_params"] = ema
    return info
