"""Text model topologies (paddle_tpu/models/text.py)."""

from paddle_tpu_torch import activation as A
from paddle_tpu_torch import data_type
from paddle_tpu_torch import layer as L
from paddle_tpu_torch import networks
from paddle_tpu_torch import pooling as pool


def text_classification_lstm(dict_size=30000, emb_size=128, hidden=128,
                             num_classes=2, num_layers=1):
    """Stacked-LSTM text classification (reference: quick_start
    trainer_config.lstm.py and benchmark/paddle/rnn/rnn.py — 2x LSTM + fc
    over IMDB). The flagship is ``num_layers=2, hidden=256``; layer and
    parameter names are the JAX builder's (lstm_emb, lstm<i>_transform,
    lstm<i>, lstm_out)."""
    words = L.data(name="word",
                   type=data_type.integer_value_sequence(dict_size))
    emb = L.embedding(input=words, size=emb_size, name="lstm_emb")
    t = emb
    for i in range(num_layers):
        t = networks.simple_lstm(input=t, size=hidden, name="lstm%d" % i)
    pooled = L.pooling(input=t, pooling_type=pool.MaxPooling())
    return L.fc(input=pooled, size=num_classes, act=A.Softmax(),
                name="lstm_out")


def sequence_tagging_rnn(word_dict_size=5000, label_dict_size=67,
                         emb_size=64, hidden=128):
    """BiLSTM tagger emitting per-step label scores (reference:
    v1_api_demo/sequence_tagging rnn_crf.py minus the CRF head, which
    attaches through layer.crf; paddle_tpu/models/text.py:44-57): an
    embedding, a forward and a reversed simple_lstm, their concat, and an
    fc to the label scores. Layer and parameter names are the JAX
    builder's (tag_emb, tag_fwd, tag_bwd, tag_concat, tag_scores)."""
    words = L.data(name="word",
                   type=data_type.integer_value_sequence(word_dict_size))
    emb = L.embedding(input=words, size=emb_size, name="tag_emb")
    fwd = networks.simple_lstm(input=emb, size=hidden, name="tag_fwd")
    bwd = networks.simple_lstm(input=emb, size=hidden, reverse=True,
                               name="tag_bwd")
    merged = L.concat(input=[fwd, bwd], name="tag_concat")
    return L.fc(input=merged, size=label_dict_size, act=None,
                name="tag_scores")


def sequence_tagging_gru(dict_size=1000, label_size=16, emb_size=32,
                         hidden=64, name="gru_tag"):
    """Forward-GRU tagger emitting per-timestep label probabilities
    (paddle_tpu/models/text.py:60; reference lineage: the
    sequence_tagging demo's RNN half): embedding, simple_gru, fc + softmax
    at every position. Layer and parameter names are the JAX builder's
    (<name>_emb, <name>_gru_transform, <name>_gru, <name>_out)."""
    words = L.data(name="word",
                   type=data_type.integer_value_sequence(dict_size))
    emb = L.embedding(input=words, size=emb_size, name=name + "_emb")
    rnn = networks.simple_gru(input=emb, size=hidden, name=name + "_gru")
    return L.fc(input=rnn, size=label_size, act=A.Softmax(),
                name=name + "_out")
