"""Text model topologies (paddle_tpu/models/text.py)."""

from paddle_tpu_torch import activation as A
from paddle_tpu_torch import data_type
from paddle_tpu_torch import layer as L
from paddle_tpu_torch import networks
from paddle_tpu_torch import pooling as pool


def text_classification_lr(dict_size=30000, num_classes=2):
    """Logistic regression over a bag of words (reference: v1_api_demo/
    quick_start trainer_config.lr.py; paddle_tpu/models/text.py:10): a
    sparse binary slot ``word`` into a softmax fc ``lr_out``. At
    ``dict_size`` >= the ``sparse_feed_threshold`` flag the slot feeds as
    SparseRows and the fc gathers rows."""
    words = L.data(name="word",
                   type=data_type.sparse_binary_vector(dict_size))
    return L.fc(input=words, size=num_classes, act=A.Softmax(),
                name="lr_out")


def text_classification_cnn(dict_size=30000, emb_size=128, hidden=128,
                            num_classes=2):
    """Text CNN (reference: quick_start trainer_config.cnn.py;
    paddle_tpu/models/text.py:18): embedding ``cnn_emb``, a context window
    of 3 with an fc and max pooling (``sequence_conv_pool``, ``cnn_conv``)
    and a softmax fc ``cnn_out``."""
    words = L.data(name="word",
                   type=data_type.integer_value_sequence(dict_size))
    emb = L.embedding(input=words, size=emb_size, name="cnn_emb")
    conv = networks.sequence_conv_pool(input=emb, context_len=3,
                                       hidden_size=hidden, name="cnn_conv")
    return L.fc(input=conv, size=num_classes, act=A.Softmax(),
                name="cnn_out")


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


def ngram_lm(dict_size=2000, emb_size=32, hidden=64, gram_n=4):
    """N-gram neural language model (reference: the v1 word-embedding
    demo over imikolov; paddle_tpu/models/text.py:78): ``gram_n`` id slots
    ``w0``.. embedded through ONE table shared by name
    (``ngram_emb_table``), concatenated, a relu fc ``ngram_h`` and a
    softmax fc over the dictionary ``ngram_out``."""
    from paddle_tpu_torch.attr import ParamAttr

    grams = [L.data(name="w%d" % i, type=data_type.integer_value(dict_size))
             for i in range(gram_n)]
    embs = [L.embedding(input=g, size=emb_size,
                        param_attr=ParamAttr(name="ngram_emb_table"))
            for g in grams]
    merged = L.concat(input=embs, name="ngram_concat")
    h = L.fc(input=merged, size=hidden, act=A.Relu(), name="ngram_h")
    return L.fc(input=h, size=dict_size, act=A.Softmax(), name="ngram_out")


def seq2seq_attention(src_dict_size=30000, trg_dict_size=30000, emb_size=64,
                      enc_size=64, dec_size=64, name="nmt", bos_id=0,
                      eos_id=1):
    """Attention NMT encoder-decoder (paddle_tpu/models/text.py:96-165;
    reference: the demo/seqToseq configs): a bidirectional GRU encoder,
    simple_attention, and a GRU decoder in a recurrent_group booted from
    the reversed GRU's first step. Layer and parameter names are the JAX
    builder's.

    Returns (cost, make_generator): ``cost`` trains with the feeds
    source_words, target_words (<s>-prefixed) and target_next_words
    (</s>-suffixed); ``make_generator(beam_size, max_length)`` builds a
    BeamSearchGenerator over a second copy of the encoder that reads the
    trained parameters by name.
    """
    def encoder():
        src = L.data(name="source_words",
                     type=data_type.integer_value_sequence(src_dict_size))
        emb = L.embedding(input=src, size=emb_size, name=name + "_src_emb")
        fwd = networks.simple_gru(input=emb, size=enc_size,
                                  name=name + "_enc_fwd")
        bwd = networks.simple_gru(input=emb, size=enc_size, reverse=True,
                                  name=name + "_enc_bwd")
        encoded = L.concat(input=[fwd, bwd], name=name + "_encoded")
        enc_proj = L.fc(input=encoded, size=dec_size, act=None,
                        bias_attr=False, name=name + "_enc_proj")
        boot = L.fc(input=L.first_seq(input=bwd), size=dec_size,
                    act=A.Tanh(), name=name + "_dec_boot")
        return encoded, enc_proj, boot

    def step_factory(boot):
        def step(enc_seq_s, enc_proj_s, trg_emb_t):
            dec_mem = L.memory(name=name + "_dec_h", size=dec_size,
                               boot_layer=boot)
            context = networks.simple_attention(
                encoded_sequence=enc_seq_s, encoded_proj=enc_proj_s,
                decoder_state=dec_mem, name=name + "_att")
            gin = L.fc(input=[context, trg_emb_t], size=dec_size * 3,
                       act=None, name=name + "_gru_in")
            h = L.gru_step(input=gin, output_mem=dec_mem, size=dec_size,
                           name=name + "_dec_h")
            return L.fc(input=h, size=trg_dict_size, act=A.Softmax(),
                        name=name + "_out")

        return step

    encoded, enc_proj, boot = encoder()
    trg = L.data(name="target_words",
                 type=data_type.integer_value_sequence(trg_dict_size))
    trg_next = L.data(name="target_next_words",
                      type=data_type.integer_value_sequence(trg_dict_size))
    trg_emb = L.embedding(input=trg, size=emb_size, name=name + "_trg_emb")
    dec_out = L.recurrent_group(
        step=step_factory(boot),
        input=[L.StaticInput(input=encoded, is_seq=True),
               L.StaticInput(input=enc_proj, is_seq=True), trg_emb],
        name=name + "_decoder")
    cost = L.classification_cost(input=dec_out, label=trg_next,
                                 name=name + "_cost")

    def make_generator(beam_size=4, max_length=30):
        encoded_g, enc_proj_g, boot_g = encoder()
        return L.beam_search(
            step=step_factory(boot_g),
            input=[L.StaticInput(input=encoded_g, is_seq=True),
                   L.StaticInput(input=enc_proj_g, is_seq=True),
                   L.GeneratedInput(size=trg_dict_size,
                                    embedding_name=name + "_trg_emb.w0",
                                    embedding_size=emb_size,
                                    bos_id=bos_id, eos_id=eos_id)],
            bos_id=bos_id, eos_id=eos_id, beam_size=beam_size,
            max_length=max_length, name=name + "_gen")

    return cost, make_generator


def flagship(dict_size=30000, emb=128, hidden=256, classes=2,
             sharded_emb_mesh=None):
    """The flagship as the JAX package's ``__graft_entry__._flagship``
    builds it: embedding, 2 x ``simple_lstm``, max pooling, a softmax fc
    and the classification cost, its layers named ``flag_*``. With ``sharded_emb_mesh`` (a parallel.Mesh) the embedding
    table is vocab-sharded over its ``model`` axis (parallel/
    sharded_embedding.py). Returns (words, label, out, cost); layer names
    count from zero."""
    from paddle_tpu_torch.graph import reset_name_counters

    reset_name_counters()
    words = L.data(name="word",
                   type=data_type.integer_value_sequence(dict_size))
    label = L.data(name="label", type=data_type.integer_value(classes))
    if sharded_emb_mesh is not None:
        from paddle_tpu_torch.parallel.sharded_embedding import (
            sharded_embedding_layer)

        embedding = sharded_embedding_layer(words, emb, sharded_emb_mesh,
                                            axis="model", name="flag_emb")
    else:
        embedding = L.embedding(input=words, size=emb, name="flag_emb")
    l1 = networks.simple_lstm(input=embedding, size=hidden,
                              name="flag_lstm1")
    l2 = networks.simple_lstm(input=l1, size=hidden, name="flag_lstm2")
    pooled = L.pooling(input=l2, pooling_type=pool.MaxPooling())
    out = L.fc(input=pooled, size=classes, act=A.Softmax(), name="flag_out")
    cost = L.classification_cost(input=out, label=label)
    return words, label, out, cost
