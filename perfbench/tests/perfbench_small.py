"""Small configurations and mixes of the four kinds of cell, for the CPU
tests: the same model types, drivers and limits at sizes a test holds.
``qwen2.5-3b.serve.chat`` is not a cell of ``BENCHMARK.json`` (PERF.md
§7); its entry here keeps the paged engine's Qwen path under the
harness's tests, with the chat mix and its own limits file."""
QWEN = {"model_type": "qwen2", "name": "qwen2-small", "source": "test",
        "hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2,
        "num_attention_heads": 4, "num_key_value_heads": 2,
        "vocab_size": 256, "rope_theta": 1e6, "rms_norm_eps": 1e-6,
        "tie_word_embeddings": True}
MAMBA = {"model_type": "mamba2", "name": "mamba2-small", "source": "test",
         "d_model": 64, "n_layer": 2, "vocab_size": 250,
         "pad_vocab_size_multiple": 16, "tie_embeddings": False,
         "d_state": 16, "d_conv": 4, "expand": 2, "headdim": 16,
         "ngroups": 1, "chunk_size": 16, "norm_epsilon": 1e-5}
TRAIN = {"seq": 64, "L": 3, "check_rounds": 2}
SERVE = {"arrivals": {"process": "poisson", "rate_per_s": 20.0},
         "prompt_len": {"dist": "lognormal", "median": 24, "sigma": 1.0,
                        "min": 4, "max": 96},
         "output_len": {"dist": "lognormal", "median": 8, "sigma": 0.7,
                        "min": 4, "max": 24},
         "engine": {"slots": 4, "page_size": 8, "prefill_chunk": 16,
                    "decode_chunk": 4, "use_paged_kernel": True},
         "warmup": [{"prompt": 20, "output": 5}], "check_sample": 6}
CELLS = {"qwen2.5-3b.train.seq2048": (QWEN, TRAIN),
         "mamba2-1.3b.train.seq2048": (MAMBA, TRAIN),
         "qwen2.5-3b.serve.chat": (QWEN, SERVE),
         "mamba2-1.3b.serve.chat": (MAMBA, SERVE)}


def manifest():
    """``BENCHMARK.json`` with the cells above that it does not hold."""
    from perfbench import harness
    man = harness.manifest()
    have = {w["name"]: w for w in man["workloads"]}
    chat = have["mamba2-1.3b.serve.chat"]["traffic"]
    man["workloads"] += [{"name": n, "config": "qwen2.5-3b", "traffic": chat,
                          "chips": 1} for n in CELLS if n not in have]
    return man


def open_small(name, seed=20260518, seconds=1.0, trace=False):
    import torch
    from perfbench import harness
    cfg, over = CELLS[name]
    return harness.open_cell(name, seed, seconds, trace, torch.device("cpu"),
                             man=manifest(), cfg=dict(cfg), mix_over=over)
