#!/bin/bash
# HSTU-large on ML-1M through the PyTorch port (Zhai et al., ICML 2024;
# generative-recommenders configs/ml-1m/hstu-sampled-softmax-n128-large-final.gin):
# 8 layers, 2 heads of 25, d=50, 200-item histories, dropout 0.2, sampled
# softmax over 128 negatives at temperature 0.05 on L2-normalized
# embeddings, learning rate 1e-3, batch 128. The timestamp term of the
# relative bias is not modelled; the port trains the last position of an
# autoregressive window with history-rejected negatives and plain Adam.
set -e
DATA_ROOT=${DATA_ROOT:-"$HOME/.unirec/data/ml-1m"}
python -m unirec_tpu_torch.cli train --model HSTU --dataloader SeqRecDataset \
  --dataset_path "$DATA_ROOT" --output_path "${OUT:-$HOME/.unirec/output/hstu}" \
  --exp_name hstu-large --n_layers 8 --n_heads 2 --embedding_size 50 --hidden_size 50 \
  --max_seq_len 200 --hidden_dropout_prob 0.2 --layer_norm_eps 1e-6 \
  --loss_type softmax --n_sample_neg_train 128 --distance_type cosine --tau 0.05 \
  --history_mask_mode autoregressive --user_history_filename user_history \
  --valid_protocol one_vs_all --test_protocol one_vs_all \
  --metrics "['hit@10;50;200', 'ndcg@10;50;200', 'mrr@10;50;200']" --key_metric ndcg@10 \
  --batch_size 128 --learning_rate 0.001 --epochs 101 --early_stop 10 "$@"
